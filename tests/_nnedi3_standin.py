"""The stand-ins for the nnedi3 shaders that the port's tests (the card's
too) and tools/torch_kernel_table.py drive.

The shaders are in the RetroArch corpus, which the repo does not carry.
The nnedi3 hand kernels never evaluate the fragment body: they read the
pass config (NEAREST, clamp_to_edge, a doubling of one axis) and the
net's weights, which they parse from the shader text: per neuron one line
``sum1=...;sum2=...;WS(a,b);`` whose two sums each hold 8 terms
``W(s,a,b,c,d)`` (s the sample, a..d the int bits of its four f32
weights) and whose ``WS`` holds the two biases' bits. So a passthrough
shader that carries such lines in a comment, under a registry basename,
drives the full nnedi3 computation in both engines. The weights are
random finite f32 values from ``numpy.random.default_rng(seed)``.

The line form and the passthrough shader are the benchmark's
(``bench_torch/presets/nnedi3-nns64-2x-nns32-4x-rgb.py``), whose writer
``write_4x_chain`` is: the four passes of nnedi3-nns64-2x-nns32-4x-rgb.
"""

import importlib.util
import os
from pathlib import Path

import numpy as np

_spec = importlib.util.spec_from_file_location(
    "nnedi3_4x_preset",
    Path(__file__).resolve().parents[1] / "bench_torch" / "presets" / "nnedi3-nns64-2x-nns32-4x-rgb.py",
)
PRESET_4X = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(PRESET_4X)

NAMES = [
    f"nnedi3-nns{nns}-win8x4-{p}-{kind}.glsl"
    for nns in (16, 32, 64)
    for p in ("pass1", "pass2")
    for kind in ("luma", "rgb")
]

PASSTHROUGH_GLSL = PRESET_4X.PASSTHROUGH_GLSL

# pass1 doubles y (source 1 x 2), pass2 doubles x (source 2 x 1).
CHAIN_GLSLP = """shaders = 2
shader0 = {pass1}
filter_linear0 = false
wrap_mode0 = clamp_to_edge
scale_type0 = source
scale_x0 = 1.0
scale_y0 = 2.0
shader1 = {pass2}
filter_linear1 = false
wrap_mode1 = clamp_to_edge
scale_type_x1 = source
scale_x1 = 2.0
{pass2_y}
"""

ONE_PASS_GLSLP = """shaders = 1
shader0 = {shader}
filter_linear0 = false
wrap_mode0 = clamp_to_edge
scale_type0 = source
scale_x0 = {sx}
scale_y0 = {sy}
float_framebuffer0 = {float_fb}
"""


def nns_of(name: str) -> int:
    return int(name.split("-")[1][3:])


def net_text(nns: int, seed: int, terms: int = 8, repeat_sample: bool = False, bad_weight: bool = False) -> str:
    """``nns`` neuron lines with random finite f32 weights as int bits.
    ``terms`` < 8, ``repeat_sample`` and ``bad_weight`` (an inf weight)
    make a text the parser refuses."""
    rng = np.random.default_rng(seed)

    def bits(n, scale):
        return (rng.standard_normal(n) * scale).astype(np.float32).view(np.int32)

    samples = [0] * terms if repeat_sample else list(range(terms))
    lines = []
    for k in range(nns):
        w1, w2 = bits(32, 0.25), bits(32, 0.25)
        if bad_weight and k == 0:
            w1[0] = np.array(np.inf, np.float32).view(np.int32)
        b = bits(2, 0.5)
        lines.append(PRESET_4X.neuron_line(w1, w2, b[0], b[1], samples))
    return "\n".join(lines)


def write_shader(directory, name: str, seed: int = 0, **kw) -> str:
    """Write the stand-in ``name`` (a registry basename) with its net;
    its path."""
    path = os.path.join(directory, name)
    with open(path, "w") as f:
        f.write(PASSTHROUGH_GLSL.replace("{net}", net_text(nns_of(name), seed, **kw)))
    return path


def write_chain(directory, nns: int = 64, kind: str = "rgb", seed: int = 0, height=None) -> str:
    """The 2-pass preset (pass1 source 1 x 2, pass2 source 2 x 1, NEAREST,
    clamp_to_edge) over stand-ins of ``nns`` neurons; its path.

    A last pass whose y scale is source 1.0 renders at the viewport's
    height (scale.py), where the pass-2 entry declines: the corpus presets
    end in a further pass at the viewport. With ``height`` (the doubled
    source height) pass 2 keeps that height by an absolute y scale, so
    that the chain ends at 2h x 2w and the blit takes it to any viewport."""
    names = [f"nnedi3-nns{nns}-win8x4-{p}-{kind}.glsl" for p in ("pass1", "pass2")]
    for i, n in enumerate(names):
        write_shader(directory, n, seed + i)
    if height is None:
        pass2_y = "scale_type_y1 = source\nscale_y1 = 1.0"
    else:
        pass2_y = f"scale_type_y1 = absolute\nscale_y1 = {height}"
    path = os.path.join(directory, f"nnedi3-nns{nns}-{kind}-{height}.glslp")
    with open(path, "w") as f:
        f.write(CHAIN_GLSLP.format(pass1=names[0], pass2=names[1], pass2_y=pass2_y))
    return path


def write_one_pass(directory, name: str, seed: int = 0, scale=None, float_framebuffer=False) -> str:
    """A one-pass preset of stand-in ``name`` at its doubling (or at
    ``scale`` = (sx, sy)); ``float_framebuffer`` keeps the pass's f32
    output unquantized. Its path."""
    write_shader(directory, name, seed)
    sx, sy = scale or ((1.0, 2.0) if "-pass1-" in name else (2.0, 1.0))
    path = os.path.join(directory, f"{name[:-5]}-{sx}x{sy}-{int(float_framebuffer)}.glslp")
    with open(path, "w") as f:
        f.write(ONE_PASS_GLSLP.format(shader=name, sx=sx, sy=sy, float_fb="true" if float_framebuffer else "false"))
    return path


def write_4x_chain(directory, height: int) -> str:
    """The four passes of nnedi3-nns64-2x-nns32-4x-rgb (the benchmark's
    preset: y and x doubled by the nns64 net, then again by the nns32 net),
    the last pass at the absolute y ``height`` (4 x the source height); its
    path."""
    return PRESET_4X.write(directory, height=height)
