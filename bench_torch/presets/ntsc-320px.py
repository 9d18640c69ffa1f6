"""The stand-in for ntsc/ntsc-320px.glslp that the benchmark drives.

Copied from tests/_ntsc_standin.py (``write_chain`` at 1280 wide, the
composite pass 1 and the gamma pass 2), so that a change to the tests
cannot move the benchmark's preset.

The shaders are in the RetroArch corpus, which the repo does not carry.
The ntsc hand kernels never evaluate the fragment body: pass 1 reads the
pass config (NEAREST, clamp_to_edge, no mipmap, ``frame_count_mod = 2``,
an integer x ratio at the source height) and FrameCount; pass 2 reads the
pass config (an x ratio of 1/2) and the source height. So passthrough
shaders under the upstream basenames, in a preset of ntsc-320px.glslp's
form, drive the full ntsc computation. The pass 1 stand-in reads
FrameCount, as the real pass 1 does (its chroma phase), in a product that
leaves the passthrough exact: the program's usage scan then gives the
chain the real one's FrameCount period of 2, which the fc-period grouped
batch branch needs.
"""

import os

PASS1 = "ntsc-pass1-composite-2phase.glsl"
PASS2 = "ntsc-pass2-2phase-gamma.glsl"
WIDTH = 1280  # pass 0's absolute x: 4 x 320

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

# x * (float(FrameCount) * 0.0 + 1.0) is x, bit for bit.
PASS1_GLSL = PASSTHROUGH_GLSL.replace(
    "uniform sampler2D Texture;\n",
    "uniform sampler2D Texture;\nuniform int FrameCount;\n",
).replace(
    "gl_FragColor = texture2D(Texture, vTexCoord);",
    "gl_FragColor = texture2D(Texture, vTexCoord) * (float(FrameCount) * 0.0 + 1.0);",
)

# ntsc-320px.glslp: pass 0 absolute x, source y 1.0, FrameCount mod 2,
# float framebuffer; pass 1 source 0.5 x 1.0 (the last pass: its y lands
# at the viewport height).
STANDIN_GLSLP = f"""shaders = 2
shader0 = {PASS1}
shader1 = {PASS2}
filter_linear0 = false
filter_linear1 = false
scale_type_x0 = absolute
scale_type_y0 = source
scale_x0 = {WIDTH}
scale_y0 = 1.0
frame_count_mod0 = 2
float_framebuffer0 = true
scale_type1 = source
scale_x1 = 0.5
scale_y1 = 1.0
"""


def write(directory) -> str:
    """Write the two shaders and ntsc-320px.glslp into ``directory``; the
    preset's path."""
    for name, text in ((PASS1, PASS1_GLSL), (PASS2, PASSTHROUGH_GLSL)):
        with open(os.path.join(directory, name), "w") as f:
            f.write(text)
    path = os.path.join(directory, "ntsc-320px.glslp")
    with open(path, "w") as f:
        f.write(STANDIN_GLSLP)
    return path
