"""The stand-ins for the ntsc 2-phase shaders that the port's tests and
chip_smoke.py drive.

The shaders are in the RetroArch corpus, which the repo does not carry.
The ntsc hand kernels never evaluate the fragment body: pass 1 reads the
pass config (NEAREST, clamp_to_edge, no mipmap, ``frame_count_mod = 2``,
an integer x ratio at the source height) and FrameCount; pass 2 reads the
pass config (an x ratio of 1/2) and the source height. So passthrough
shaders under the registry's basenames, in a preset of ntsc-320px's form
(bench.py:47; tests/test_kernels_ntsc.py:84-101 writes it at 256 wide),
drive the full ntsc computation in both engines.
"""

import os

PASS1 = {"composite": "ntsc-pass1-composite-2phase.glsl", "svideo": "ntsc-pass1-svideo-2phase.glsl"}
PASS2 = {
    "plain": "ntsc-pass2-2phase.glsl",
    "gamma": "ntsc-pass2-2phase-gamma.glsl",
    "linear": "ntsc-pass2-2phase-linear.glsl",
}

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
void main()
{
    gl_FragColor = texture2D(Texture, vTexCoord);
}
#endif
"""

# ntsc-320px.glslp's form: pass 0 absolute x (4 x 320 there), source y
# 1.0, FrameCount mod 2, float framebuffer; pass 1 source 0.5 x 1.0.
CHAIN_GLSLP = """shaders = 2
shader0 = {pass1}
shader1 = {pass2}
filter_linear0 = {linear}
filter_linear1 = false
scale_type_x0 = absolute
scale_type_y0 = source
scale_x0 = {width}
scale_y0 = 1.0
frame_count_mod0 = {mod}
float_framebuffer0 = true
scale_type1 = source
scale_x1 = 0.5
scale_y1 = 1.0
"""

PASS1_GLSLP = """shaders = 1
shader0 = {pass1}
filter_linear0 = {linear}
scale_type_x0 = absolute
scale_type_y0 = source
scale_x0 = {width}
scale_y0 = 1.0
frame_count_mod0 = {mod}
float_framebuffer0 = true
"""

PASS2_GLSLP = """shaders = 1
shader0 = {pass2}
filter_linear0 = {linear}
scale_type0 = source
scale_x0 = {ratio}
scale_y0 = 1.0
float_framebuffer0 = {float_fb}
"""


def _write_shaders(directory):
    for name in list(PASS1.values()) + list(PASS2.values()):
        with open(os.path.join(directory, name), "w") as f:
            f.write(PASSTHROUGH_GLSL)


def _preset(directory, name, text):
    _write_shaders(directory)
    path = os.path.join(directory, name)
    with open(path, "w") as f:
        f.write(text)
    return path


def write_chain(directory, width, pass1="composite", pass2="gamma", filter_linear=False, frame_count_mod=2) -> str:
    """The two-pass preset of ntsc-320px's form, pass 0 ``width`` wide;
    its path."""
    text = CHAIN_GLSLP.format(
        pass1=PASS1[pass1], pass2=PASS2[pass2], width=width, mod=frame_count_mod,
        linear="true" if filter_linear else "false",
    )
    return _preset(directory, f"ntsc-{pass1}-{pass2}-{width}-{int(filter_linear)}-{frame_count_mod}.glslp", text)


def write_pass1(directory, width, pass1="composite", filter_linear=False, frame_count_mod=2) -> str:
    """A one-pass preset of pass 1 alone (``width`` wide, source height:
    give the engine a viewport of the source height, where the last pass's
    source y scale lands)."""
    text = PASS1_GLSLP.format(
        pass1=PASS1[pass1], width=width, mod=frame_count_mod, linear="true" if filter_linear else "false"
    )
    return _preset(directory, f"ntsc1-{pass1}-{width}-{int(filter_linear)}-{frame_count_mod}.glslp", text)


def write_pass2(directory, pass2="gamma", filter_linear=False, ratio=0.5, float_framebuffer=False) -> str:
    """A one-pass preset of pass 2 alone, x scale ``ratio`` of the source
    (the entry takes 0.5 only); the last pass's y lands at the viewport
    height, so a viewport taller than the source expands rows.
    ``float_framebuffer`` keeps the pass's f32 output unquantized."""
    text = PASS2_GLSLP.format(
        pass2=PASS2[pass2], ratio=ratio, linear="true" if filter_linear else "false",
        float_fb="true" if float_framebuffer else "false",
    )
    return _preset(directory, f"ntsc2-{pass2}-{int(filter_linear)}-{ratio}-{int(float_framebuffer)}.glslp", text)
