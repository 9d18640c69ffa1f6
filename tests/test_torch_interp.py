"""The port's GLSL evaluator (frontend/values, builtins, interp) against
the JAX package's, through both engines, on shaders that reach the
constructs the slice's evaluator must carry: predicated control flow on
per-pixel values, counted and data-dependent loops with break/continue,
arrays with dynamic indices, structs, matrices, user functions with out
parameters, the driver-probed builtins (pow, sin/cos, NaN order of
min/max) and quad derivatives.

Each pass stores to a float framebuffer and the viewport equals the
source, so no quantizer hides a difference. Tolerance: 2e-5 absolute on
values of magnitude <= ~8, NaN positions equal. Reason: XLA-CPU fuses
``a*b + c`` into FMAs and computes exp2/log2 with its own polynomials;
eager torch rounds each op and calls its own exp2/log2 (measured max
|d| <= 9.6e-7 here, on values up to 8.2).
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import retrocapture_tpu as jax_pkg
import retrocapture_tpu_torch as torch_pkg

HW = (24, 32)

VERTEX = """#if defined(VERTEX)
attribute vec4 VertexCoord;
attribute vec4 TexCoord;
varying vec2 vTexCoord;
uniform mat4 MVPMatrix;
void main()
{
    gl_Position = MVPMatrix * VertexCoord;
    vTexCoord = TexCoord.xy;
}
#elif defined(FRAGMENT)
varying vec2 vTexCoord;
uniform sampler2D Texture;
uniform vec2 TextureSize;
uniform int FrameCount;
"""

SHADERS = {
    "control_flow": """
struct Acc { vec3 sum; float n; };

float weight(float x, out float sq)
{
    sq = x * x;
    if (x > 0.5) return 1.0 - x;
    return x;
}

void main()
{
    vec4 c = texture2D(Texture, vTexCoord);
    Acc acc;
    acc.sum = vec3(0.0);
    acc.n = 0.0;
    for (int i = 0; i < 5; i++) {
        if (i == 3) continue;
        vec2 off = vec2(float(i) - 2.0, 0.0) / TextureSize;
        vec3 t = texture2D(Texture, vTexCoord + off).rgb;
        if (t.r > c.g) {
            acc.sum += t;
            acc.n += 1.0;
        } else {
            acc.sum -= 0.25 * t;
        }
        if (acc.n > 2.5) break;
    }
    float k = 0.0;
    float v = c.b;
    for (int j = 0; j < 6; j++) {
        if (v >= 0.9) break;
        v += 0.2;
        k += 1.0;
    }
    float sq;
    float w = weight(c.r, sq);
    gl_FragColor = vec4(acc.sum / max(acc.n, 1.0) + (w + sq) + k * 0.01, 1.0);
}
""",
    "arrays_matrices": """
void main()
{
    vec4 c = texture2D(Texture, vTexCoord);
    float taps[4];
    taps[0] = 0.1; taps[1] = 0.2; taps[2] = 0.3; taps[3] = 0.4;
    int idx = int(c.r * 5.0);
    float t = taps[idx];
    vec3 pal[3] = vec3[](vec3(1.0, 0.0, 0.0), vec3(0.0, 1.0, 0.0), vec3(0.0, 0.0, 1.0));
    vec3 p = pal[int(mod(floor(c.g * 7.0), 3.0))];
    mat3 m = mat3(0.9, 0.1, 0.0, 0.05, 0.9, 0.05, 0.0, 0.2, 0.8);
    mat2 r = mat2(cos(c.b), sin(c.b), -sin(c.b), cos(c.b));
    vec2 q = r * (vTexCoord - 0.5);
    m[2] = vec3(q, t);
    vec3 o = m * c.rgb + transpose(m) * p;
    gl_FragColor = vec4(o + c.a * t + (c.b > 0.5 ? q.x : q.y), 1.0);
}
""",
    "builtins": """
void main()
{
    vec4 c = texture2D(Texture, vTexCoord);
    float a = pow(c.r, 2.2) + pow(c.g, 2.0) + pow(c.b - 0.5, 1.5);
    float s = sin(c.r * 12.0) * cos(c.g * 7.0);
    float nan_ = sqrt(c.b - 0.6);
    float mn = min(nan_, c.r) + max(c.g, nan_);
    float sm = smoothstep(0.2, 0.8, c.a) + step(0.5, c.r) + fract(c.g * 3.7);
    float md = mod(c.r * 10.0 - 5.0, 3.0) + clamp(c.b * 2.0 - 0.5, 0.0, 1.0);
    float h = fract(sin(dot(vTexCoord, vec2(12.9898, 78.233))) * 43758.5453);
    float len = length(c.rgb) + distance(c.rg, vec2(0.5)) + dot(normalize(c.rgb + 0.1), vec3(0.3));
    // The output is RGB: alpha is dropped at the blit.
    gl_FragColor = vec4(a + s, mn + sm + h, md + len, 1.0);
}
""",
    "derivatives_fetch": """
void main()
{
    vec4 c = texture2D(Texture, vTexCoord);
    float d = dFdx(c.r) + 2.0 * dFdy(c.g) + fwidth(c.b);
    ivec2 ts = textureSize(Texture, 0);
    ivec2 ip = ivec2(vTexCoord * vec2(ts)) + ivec2(-1, 1);
    vec4 f = texelFetch(Texture, ip, 0);
    float fc = float(FrameCount) * 0.001;
    gl_FragColor = vec4(d + abs(d) + sign(d - 0.1), f.r + fc, f.g * float(ts.x) / 32.0, 1.0);
}
""",
}

GLSLP = """shaders = 1
shader0 = {name}.glsl
filter_linear0 = false
float_framebuffer0 = true
scale_type0 = source
scale0 = 1.0
"""


@pytest.mark.parametrize("name", sorted(SHADERS))
def test_evaluator_matches_jax(name):
    rng = np.random.default_rng(sorted(SHADERS).index(name))
    frames = rng.integers(0, 256, (2,) + HW + (3,), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as td:
        with open(os.path.join(td, f"{name}.glsl"), "w") as f:
            f.write(VERTEX + SHADERS[name] + "\n#endif\n")
        with open(os.path.join(td, f"{name}.glslp"), "w") as f:
            f.write(GLSLP.format(name=name))
        je = jax_pkg.Engine()
        te = torch_pkg.Engine(device="cpu")
        for e in (je, te):
            assert e.load_preset(os.path.join(td, f"{name}.glslp")), e.last_error
        outs = []
        for _ in range(2):
            a = np.asarray(je.apply(frames))
            b = te.apply(torch.from_numpy(frames)).numpy()
            outs.append((a, b))
    for e in (je, te):
        assert e.shader_active and e.last_error is None, e.last_error
    for a, b in outs:
        assert a.shape == b.shape == (2,) + HW + (3,)
        assert np.array_equal(np.isnan(a), np.isnan(b))
        d = np.abs(np.nan_to_num(a.astype(np.float64)) - np.nan_to_num(b))
        assert d.max() <= 2e-5, f"max |d| {d.max():.3e}"


THREE_TERMS = """
void main()
{
    vec4 c = texture2D(Texture, vTexCoord);
    vec4 p = texture2D(Texture, vTexCoord + vec2(1.0, 0.0) / TextureSize);
    vec4 q = texture2D(Texture, vTexCoord + vec2(0.0, 1.0) / TextureSize);
    gl_FragColor = 0.5 * c + 0.3 * p + 0.2 * q;
}
"""

# The pass renders at 2.5x its 24x32 source, so its NEAREST taps take the
# separable one-hot lowering, where the reference re-quantises a tap of
# an RGBA8-quantized texture through uint8.
UPSCALE_GLSLP = """shaders = 1
shader0 = three.glsl
filter_linear0 = false
float_framebuffer0 = true
scale_type0 = viewport
scale0 = 1.0
"""


@pytest.mark.parametrize("quantized", [True, False], ids=["u8-input", "f32-input"])
def test_three_term_sum_matches_jax_bit_for_bit(quantized):
    """``0.5*c + 0.3*p + 0.2*q`` over three NEAREST taps, stored to a float
    framebuffer so that the f32 sums are compared as they are. A u8 RGB
    frame makes the chain input quantized: the reference's HLO then folds
    each weight into its tap's u8 scale (``k * f32(w * f32(1/255))``, kept
    out of any FMA by the saturating convert), which the port mirrors. The
    same values as an f32 frame are not quantized and must not be folded:
    there the three products are plain, and XLA contracts them into the
    adds (the left product of the first add, then the next one)."""
    rng = np.random.default_rng(41)
    frames = rng.integers(0, 256, (2,) + HW + (3,), dtype=np.uint8)
    if not quantized:
        frames = (frames.astype(np.float32) * np.float32(1.0 / 255.0)).astype(np.float32)
    with tempfile.TemporaryDirectory() as td:
        with open(os.path.join(td, "three.glsl"), "w") as f:
            f.write(VERTEX + THREE_TERMS + "\n#endif\n")
        with open(os.path.join(td, "three.glslp"), "w") as f:
            f.write(UPSCALE_GLSLP)
        viewport = (80, 60)
        je = jax_pkg.Engine(viewport=viewport)
        te = torch_pkg.Engine(viewport=viewport, device="cpu")
        for e in (je, te):
            assert e.load_preset(os.path.join(td, "three.glslp")), e.last_error
        a = np.asarray(je.apply(frames, output="f32"))
        b = te.apply(torch.from_numpy(frames), output="f32").numpy()
    for e in (je, te):
        assert e.shader_active and e.last_error is None, e.last_error
    assert a.shape == b.shape == (2, 60, 80, 3)
    assert np.array_equal(a, b), f"{(a != b).mean():.2e} of values differ"
