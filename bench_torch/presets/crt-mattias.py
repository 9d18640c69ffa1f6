"""The stand-in for crt-mattias.glsl that the benchmark drives.

Copied from tests/_mattias_standin.py, so that a change to the tests
cannot move the benchmark's preset.

The shader is in the RetroArch corpus, which the repo does not carry.
The crt-mattias hand kernel never evaluates its GLSL body: it reads the
pass config (NEAREST, clamp_to_edge, viewport scale), the parameters
CURVATURE and SCANSPEED, and FrameCount. So a one-pass preset naming a
shader of that basename, with those two parameters and a passthrough
body, drives the full crt-mattias computation in both engines.
"""

import os

STANDIN_GLSL = """#pragma parameter CURVATURE "Curvature" 0.5 0.0 1.0 0.05
#pragma parameter SCANSPEED "Scanline Crawl Speed" 1.0 0.0 10.0 0.5

#if defined(VERTEX)

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

#ifdef PARAMETER_UNIFORM
uniform float CURVATURE;
uniform float SCANSPEED;
#else
#define CURVATURE 0.5
#define SCANSPEED 1.0
#endif

void main()
{
    gl_FragColor = texture2D(Texture, vTexCoord);
}

#endif
"""

STANDIN_GLSLP = """shaders = 1
shader0 = crt-mattias.glsl
filter_linear0 = false
scale_type0 = viewport
"""


def write(directory) -> str:
    """Write crt-mattias.glsl and its preset into ``directory``; the
    preset's path."""
    with open(os.path.join(directory, "crt-mattias.glsl"), "w") as f:
        f.write(STANDIN_GLSL)
    path = os.path.join(directory, "crt-mattias.glslp")
    with open(path, "w") as f:
        f.write(STANDIN_GLSLP)
    return path
