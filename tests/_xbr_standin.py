"""The stand-in for xbr-lv2.glsl that the port's tests (the card's too)
and tools/torch_kernel_table.py drive.

The shader is in the RetroArch corpus, which the repo does not carry.
The xbr-lv2 hand kernel never evaluates the fragment body: it reads the
pass config (NEAREST, clamp_to_edge, viewport scale), the four
parameters, and the rasterizer-exact planes of the vertex stage's
varyings TEX0..TEX7 (the texel-centre coordinate and the t1..t7 tap
rows and columns of the upstream shader). So a one-pass preset naming a
shader of that basename, with those parameters, that vertex stage and a
passthrough fragment, drives the full xbr-lv2 computation in both
engines. ``filter_linear=True`` writes a preset the kernel declines;
``reads_frame_count=True`` writes (into a directory of its own) the same
shader with a vertex stage that reads FrameCount, adding ``0.0 *
FrameCount`` to TEX0: the same varyings, but frame state in the stage.
"""

import os

STANDIN_GLSL = """#pragma parameter XBR_Y_WEIGHT "Y Weight" 48.0 0.0 100.0 1.0
#pragma parameter XBR_EQ_THRESHOLD "Eq Threshold" 15.0 0.0 50.0 1.0
#pragma parameter XBR_LV2_COEFFICIENT "Lv2 Coefficient" 2.0 1.0 3.0 0.1
#pragma parameter small_details "Small Details" 0.0 0.0 1.0 1.0
#if defined(VERTEX)
attribute vec4 VertexCoord; attribute vec4 TexCoord;
varying vec2 TEX0; varying vec4 TEX1; varying vec4 TEX2; varying vec4 TEX3;
varying vec4 TEX4; varying vec4 TEX5; varying vec4 TEX6; varying vec4 TEX7;
uniform mat4 MVPMatrix; uniform vec2 TextureSize;
void main() {
    gl_Position = MVPMatrix * VertexCoord;
    TEX0 = TexCoord.xy * 1.0001;
    float dx = 1.0 / TextureSize.x; float dy = 1.0 / TextureSize.y;
    TEX1 = TEX0.xxxy + vec4(-dx, 0.0, dx, -2.0 * dy);
    TEX2 = TEX0.xxxy + vec4(-dx, 0.0, dx, -dy);
    TEX3 = TEX0.xxxy + vec4(-dx, 0.0, dx, 0.0);
    TEX4 = TEX0.xxxy + vec4(-dx, 0.0, dx, dy);
    TEX5 = TEX0.xxxy + vec4(-dx, 0.0, dx, 2.0 * dy);
    TEX6 = TEX0.xyyy + vec4(-2.0 * dx, -dy, 0.0, dy);
    TEX7 = TEX0.xyyy + vec4(2.0 * dx, -dy, 0.0, dy);
}
#elif defined(FRAGMENT)
varying vec2 TEX0; uniform sampler2D Texture;
void main() { gl_FragColor = texture2D(Texture, TEX0); }
#endif
"""

_TEX0 = "TEX0 = TexCoord.xy * 1.0001;"

STANDIN_GLSLP = """shaders = 1
shader0 = xbr-lv2.glsl
filter_linear0 = {linear}
scale_type0 = viewport
"""


def write_standin(directory, filter_linear: bool = False, reads_frame_count: bool = False) -> str:
    """Write xbr-lv2.glsl and its preset into ``directory`` (into its
    ``framecount`` subdirectory with ``reads_frame_count``); the preset's
    path."""
    glsl = STANDIN_GLSL
    if reads_frame_count:
        directory = os.path.join(directory, "framecount")
        os.makedirs(directory, exist_ok=True)
        glsl = glsl.replace("uniform vec2 TextureSize;", "uniform vec2 TextureSize; uniform int FrameCount;")
        glsl = glsl.replace(_TEX0, _TEX0[:-1] + " + vec2(0.0 * float(FrameCount));")
        assert "float(FrameCount)" in glsl
    with open(os.path.join(directory, "xbr-lv2.glsl"), "w") as f:
        f.write(glsl)
    name = "xbr-lv2-linear.glslp" if filter_linear else "xbr-lv2.glslp"
    path = os.path.join(directory, name)
    with open(path, "w") as f:
        f.write(STANDIN_GLSLP.format(linear="true" if filter_linear else "false"))
    return path
