"""The stand-in for nnedi3/nnedi3-nns64-2x-nns32-4x-rgb.glslp that the
benchmark drives: its four nnedi3 passes.

The shaders are in the RetroArch corpus, which the repo does not carry,
and so are the published, trained weights. The nnedi3 hand kernels never
evaluate the fragment body: they read the pass config (NEAREST,
clamp_to_edge, a doubling of one axis) and the net, which they parse from
the shader text, in the shader's own line form: per neuron one line
``sum1=...;sum2=...;WS(b1,b2);`` whose two sums each hold 8 terms
``W(s,a,b,c,d)`` (``s`` the window's sample, ``a..d`` the int bits of its
four f32 weights) and whose ``WS`` holds the two biases' bits. So a
passthrough shader under the upstream basename, with its net in a
comment, drives the full nnedi3 computation.

The nets are seeded: the nns64 pair of shaders from one seed, the nns32
pair from another, pass 1's net drawn before pass 2's. Each weight is a
normal draw (standard deviation 1/4, the biases 1/2) rounded to f32, and
each neuron's 32 weights of a sum have their mean taken out (in f64,
before the rounding): the shader scales the raw window sum by the
window's 1/std without subtracting its mean, which is a dot with the
standardized window only for weights that sum to zero, so the sums stay
within ~8 and ``exp`` far from overflow. ``weights()`` gives the arrays
the shaders carry; the plain reference takes its nets from there.

The preset: pass 1 source 1 x 2 (y doubled), pass 2 source 2 x 1 (x
doubled), with the nns64 net; passes 3 and 4 the same with the nns32 net;
all NEAREST and clamp_to_edge. The published preset follows them with the
jinc2 passes to the viewport, which the repo does not carry; here the last
nnedi3 pass keeps its own size by an absolute y (a last pass at source y
1.0 renders at the viewport's height, where the pass-2 entry declines), and
the engine's LINEAR blit takes it to the viewport.
"""

import os

import numpy as np

NETS = (("nns64", 64, 2064), ("nns32", 32, 2032))  # (name, neurons, seed) of each pair
PASSES = [f"nnedi3-{name}-win8x4-{p}-rgb.glsl" for name, _, _ in NETS for p in ("pass1", "pass2")]
HEIGHT = 960  # the last pass's absolute y: 4 x 240

PASSTHROUGH_GLSL = """#if defined(VERTEX)
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
/*
{net}
*/
void main()
{
    gl_FragColor = texture2D(Texture, vTexCoord);
}
#endif
"""


def neuron_line(w1, w2, b1: int, b2: int, samples=range(8)) -> str:
    """One neuron in the shader's line form: ``w1``, ``w2`` the int32 bits
    of the 32 weights of ``sum1`` and ``sum2`` (weight ``4 s + c`` is
    component ``c`` of sample ``s``), ``b1``, ``b2`` the biases' bits; a
    term for each of ``samples``."""
    sums = ["+".join(f"W({s},{w[4 * s]},{w[4 * s + 1]},{w[4 * s + 2]},{w[4 * s + 3]})" for s in samples)
            for w in (w1, w2)]
    return f"sum1={sums[0]};sum2={sums[1]};WS({b1},{b2});"


def _net(rng, nns: int):
    """(W1, W2 [32, nns], B1, B2 [nns]) f32: one net's seeded draws."""

    def centred():
        w = rng.standard_normal((nns, 32)) * 0.25
        return (w - w.mean(axis=1, keepdims=True)).astype(np.float32).T

    w1, w2 = centred(), centred()
    b = (rng.standard_normal((nns, 2)) * 0.5).astype(np.float32)
    return np.ascontiguousarray(w1), np.ascontiguousarray(w2), b[:, 0].copy(), b[:, 1].copy()


def weights() -> dict:
    """Shader basename -> (W1, W2 [32, nns], B1, B2 [nns]) f32, the net the
    shader carries."""
    out = {}
    for name, nns, seed in NETS:
        rng = np.random.default_rng(seed)
        for p in ("pass1", "pass2"):
            out[f"nnedi3-{name}-win8x4-{p}-rgb.glsl"] = _net(rng, nns)
    return out


def shader_text(w1, w2, b1, b2) -> str:
    """The stand-in shader carrying the net (W1, W2, B1, B2)."""
    bits = [np.asarray(a, np.float32).view(np.int32) for a in (w1, w2, b1, b2)]
    lines = [neuron_line(bits[0][:, k], bits[1][:, k], bits[2][k], bits[3][k]) for k in range(len(bits[2]))]
    return PASSTHROUGH_GLSL.replace("{net}", "\n".join(lines))


def write(directory, height: int = HEIGHT) -> str:
    """Write the four shaders and the preset into ``directory``; the
    preset's path. ``height`` is the last pass's absolute y (4 x the
    source height: 960 at the benchmark's 240 rows)."""
    for name, net in weights().items():
        with open(os.path.join(directory, name), "w") as f:
            f.write(shader_text(*net))
    lines = [f"shaders = {len(PASSES)}"]
    for i, name in enumerate(PASSES):
        lines += [f"shader{i} = {name}", f"filter_linear{i} = false", f"wrap_mode{i} = clamp_to_edge"]
        sx, sy = (1.0, 2.0) if "-pass1-" in name else (2.0, 1.0)
        lines += [f"scale_type_x{i} = source", f"scale_x{i} = {sx}"]
        if i == len(PASSES) - 1:
            lines += [f"scale_type_y{i} = absolute", f"scale_y{i} = {height}"]
        else:
            lines += [f"scale_type_y{i} = source", f"scale_y{i} = {sy}"]
    path = os.path.join(directory, "nnedi3-nns64-2x-nns32-4x-rgb.glslp")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
