"""Small presets that the port's tests write out: a curvature warp pass,
two ``mipmap_input`` presets and feedback-ghost with its pass at the
source size.

The shaders are the repo's own (no corpus file): each is a fragment body
behind the standard RetroArch vertex stage ``VERTEX_GLSL``.
"""

from pathlib import Path

# A one-pass curvature warp at the viewport (LINEAR, clamp_to_border): the
# warped tap, one ``warp_sample`` launch a walk of the batch on the card.
WARP_GLSLP = """shaders = 1
shader0 = warp-curve.glsl
filter_linear0 = true
wrap_mode0 = clamp_to_border
scale_type0 = viewport
scale0 = 1.0
"""

VERTEX_GLSL = """#if defined(VERTEX)

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
"""

WARP_GLSL = """#pragma parameter CURV "Curvature" 0.25 0.0 1.0 0.05

""" + VERTEX_GLSL + """
varying vec2 vTexCoord;
uniform sampler2D Texture;

#ifdef PARAMETER_UNIFORM
uniform float CURV;
#else
#define CURV 0.25
#endif

void main()
{
    vec2 cc = vTexCoord - 0.5;
    float r2 = dot(cc, cc);
    gl_FragColor = texture2D(Texture, 0.5 + cc * (1.0 + CURV * r2));
}

#endif
"""

# Two presets whose input is mipmapped. mip-glow is the crt-hyllian-glow
# pattern: a pass at a fraction of the source size that blurs its input,
# whose taps are affine in the pixel, so the level of detail is one
# number (log2(1 / 0.3) = 1.74 at scale 0.3: a blend of levels 1 and 2).
MIP_GLOW_GLSLP = """shaders = 1
shader0 = mip-glow.glsl
filter_linear0 = true
mipmap_input0 = true
scale_type0 = source
scale0 = {scale}
"""

MIP_GLOW_GLSL = VERTEX_GLSL + """
varying vec2 vTexCoord;
uniform sampler2D Texture;
uniform vec2 TextureSize;

void main()
{
    vec2 d = 1.0 / TextureSize;
    vec4 c = 0.41 * texture2D(Texture, vTexCoord);
    c += 0.1475 * texture2D(Texture, vTexCoord + vec2(d.x, 0.0));
    c += 0.1475 * texture2D(Texture, vTexCoord - vec2(d.x, 0.0));
    c += 0.1475 * texture2D(Texture, vTexCoord + vec2(0.0, d.y));
    c += 0.1475 * texture2D(Texture, vTexCoord - vec2(0.0, d.y));
    gl_FragColor = c;
}

#endif
"""

# mip-warp minifies through a curvature warp (ZOOM source widths across
# the output, more towards the corners), so the level of detail differs
# per pixel and crosses whole levels: one warped sample per pyramid level.
MIP_WARP_GLSLP = """shaders = 1
shader0 = mip-warp.glsl
filter_linear0 = {linear}
wrap_mode0 = repeat
mipmap_input0 = true
scale_type0 = viewport
scale0 = 1.0
"""

MIP_WARP_GLSL = """#pragma parameter ZOOM "Zoom out" 10.0 1.0 32.0 1.0

""" + VERTEX_GLSL + """
varying vec2 vTexCoord;
uniform sampler2D Texture;

#ifdef PARAMETER_UNIFORM
uniform float ZOOM;
#else
#define ZOOM 10.0
#endif

void main()
{
    vec2 cc = vTexCoord - 0.5;
    float r2 = dot(cc, cc);
    gl_FragColor = texture2D(Texture, 0.5 + cc * (ZOOM * (1.0 + 0.5 * r2)));
}

#endif
"""

# feedback-ghost with its pass at the source size (absolute scale), so
# that the viewport blit is an integer upscale (320 -> 1920, r = 6): the
# phase-form blit's path under RCTPU_XPHASE=on.
XPHASE_GLSLP = """shaders = 1
shader0 = {shader}
filter_linear0 = false
scale_type0 = absolute
scale_x0 = {w}
scale_y0 = {h}
"""


def write_warp_preset(tmp) -> str:
    """Write the curvature warp preset under ``tmp``; its path."""
    tmp = Path(tmp)
    (tmp / "warp-curve.glslp").write_text(WARP_GLSLP)
    (tmp / "warp-curve.glsl").write_text(WARP_GLSL)
    return str(tmp / "warp-curve.glslp")


def write_mip_presets(tmp, scale=0.3, linear=True):
    """Write the two mipmapped presets under ``tmp``; their paths."""
    tmp = Path(tmp)
    (tmp / "mip-glow.glslp").write_text(MIP_GLOW_GLSLP.format(scale=scale))
    (tmp / "mip-glow.glsl").write_text(MIP_GLOW_GLSL)
    (tmp / "mip-warp.glslp").write_text(MIP_WARP_GLSLP.format(linear="true" if linear else "false"))
    (tmp / "mip-warp.glsl").write_text(MIP_WARP_GLSL)
    return str(tmp / "mip-glow.glslp"), str(tmp / "mip-warp.glslp")


def write_xphase_preset(tmp, shader, w, h) -> str:
    """Write feedback-ghost's ``shader`` as a pass at ``w`` x ``h``; its path."""
    path = Path(tmp) / "feedback-ghost-source-size.glslp"
    path.write_text(XPHASE_GLSLP.format(shader=shader, w=w, h=h))
    return str(path)
