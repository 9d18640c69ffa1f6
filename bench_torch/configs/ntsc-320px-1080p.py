"""The plain reference of ntsc-320px (libretro glsl-shaders
ntsc/ntsc-320px.glslp: ntsc-pass1-composite-2phase.glsl, then
ntsc-pass2-2phase-gamma.glsl), then the window's viewport blit, written
out in plain PyTorch.

It imports nothing of the program. Everything the shaders compute is
computed in ``dtype`` (float32 as the shaders state; the control runs it
in bfloat16), pixel by pixel as the fragments compute it:

* Pass 0, the encode, at ``WIDTH`` x the source height (absolute x,
  source y 1.0, NEAREST, FrameCount mod 2, a float framebuffer): the
  source texel under the pixel, ``rgb2yiq``, the chroma phase
  ``PI * (mod(pix_no.y, 2) + FrameCount) + pix_no.x * CHROMA_MOD_FREQ``
  at the pixel centre ``pix_no``, its cosine and sine, the modulation,
  the composite mix (``yiq *= mix_mat``) and the demodulation, kept
  unclamped.
* Pass 1, the decode, at half that width (source 0.5 x 1.0, NEAREST,
  clamp_to_edge): the vertex stage's half-texel shift puts output pixel
  ``x`` on texel ``2x``; the 65-tap luma and chroma FIRs as the fragment's
  loop writes them, the pair of taps ``2x - (32 - i)`` and ``2x + (32 - i)``
  (clamped to the edge) times the shaders' table entry ``i``, summed for
  ``i = 0 .. 31``, then the centre tap; ``yiq2rgb``; ``pow(rgb, 2.5 /
  2.0)`` (NaN where the FIR rang below 0).
* The last pass lands at the viewport height (its explicit source 1.0 y
  scale becomes the viewport's): each output row takes the source row
  under its centre (NEAREST), and the pass is stored into an RGBA8
  framebuffer (NaN stores 0, clamp, round to the nearest level).
* The window's blit stretches that to the viewport's width: LINEAR,
  clamp_to_edge, texel centres at half-texels; then the u8 pack.

Departures from the published shaders:

* The sine and cosine are torch's own, in float64 of the float32 phase,
  rounded once; the program takes them from llvmpipe's (Mesa's software
  GL) polynomials. They differ by a unit in the last place, far below one
  output level. (torch's float32 cosine on the CPU, over 4 threads, was
  seen to return values 1.4e-4 off for phases near 1000 rad in one
  thread's rows, in about one process of six.)
* The row map: at 240 -> 1080 rows the ratio is 4.5, so every ninth
  output row (120 of 1080) has its centre ``(y + 0.5) / 1080`` on a
  source-row boundary in exact arithmetic, and a naive formula puts
  whole rows one source row off. There the output depends on rounding
  alone, so the row is taken as the GL rasterizer takes it: the varying's
  plane set up in float32 (Mesa's llvmpipe, ``dady = f32(W * f32(1 / (W
  * H)))`` over the W x H target, ``a0 = dady / 2``), evaluated at the
  row as one rounding of ``a0 + dady * y``, times the source height in
  float32, floored. That geometry, and the blit's weights, are computed
  in float32 in every ``dtype``: they are the rasterizer's and the
  sampler's, not the shaders' arithmetic.
"""

from __future__ import annotations

import torch

WIDTH = 1280  # pass 0's absolute x (ntsc-320px.glslp: 4 x 320)
PI = 3.14159265  # the shaders' own constant
TAPS = 32
GAMMA = 2.5 / 2.0  # NTSC_CRT_GAMMA / NTSC_MONITOR_GAMMA

# mat3 constructors, column by column (GLSL is column-major); ``v * M``
# takes output c as dot(v, column c).
RGB2YIQ = ((0.2989, 0.5870, 0.1140), (0.5959, -0.2744, -0.3216), (0.2115, -0.5229, 0.3114))
YIQ2RGB = ((1.0, 0.956, 0.6210), (1.0, -0.2720, -0.6474), (1.0, -1.1060, 1.7046))
# mix_mat of the composite pass at BRIGHTNESS, SATURATION, FRINGING and
# ARTIFACTING 1.0: (BRIGHTNESS, FRINGING, FRINGING), (ARTIFACTING, 2
# SATURATION, 0), (ARTIFACTING, 0, 2 SATURATION).
MIX = ((1.0, 1.0, 1.0), (1.0, 2.0, 0.0), (1.0, 0.0, 2.0))

# ntsc-pass2-2phase-gamma.glsl's luma_filter[TAPS + 1] and
# chroma_filter[TAPS + 1]: entry i weighs the taps 32 - i texels away.
LUMA = (
    -0.000174844, -0.000205844, -0.000149453, -0.000051693,
    0.000000000, -0.000066171, -0.000245058, -0.000432928,
    -0.000472644, -0.000252236, 0.000198929, 0.000687058,
    0.000944112, 0.000803467, 0.000363199, 0.000013422,
    0.000253402, 0.001339461, 0.002932972, 0.003983485,
    0.003026683, -0.001102056, -0.008373026, -0.016897700,
    -0.022914480, -0.021642347, -0.008863273, 0.017271957,
    0.054921920, 0.098342579, 0.139044281, 0.168055832,
    0.178571429,
)
CHROMA = (
    0.001384762, 0.001678312, 0.002021715, 0.002420562,
    0.002880460, 0.003406879, 0.004004985, 0.004679445,
    0.005434218, 0.006272332, 0.007195654, 0.008204665,
    0.009298238, 0.010473450, 0.011725413, 0.013047155,
    0.014429548, 0.015861306, 0.017329037, 0.018817382,
    0.020309220, 0.021785952, 0.023227857, 0.024614500,
    0.025925203, 0.027139546, 0.028237893, 0.029201910,
    0.030015081, 0.030663170, 0.031134640, 0.031420995,
    0.031517031,
)


def _r(x, dtype) -> float:
    """The Python float ``x`` rounded to ``dtype``."""
    return float(torch.tensor(float(x), dtype=torch.float64).to(dtype))


def _times(v, mat, dtype):
    """``v * mat`` of GLSL for the planes ``v`` (three tensors) and a mat3
    given column by column."""
    return [v[0] * _r(c[0], dtype) + v[1] * _r(c[1], dtype) + v[2] * _r(c[2], dtype) for c in mat]


def encode(src, frame_count: int, dtype=torch.float32):
    """Pass 0: ``src`` u8 ``[h, w, 3]`` → the composite signal ``[h, WIDTH,
    3]`` in ``dtype``, as the float framebuffer holds it."""
    h, w = src.shape[0], src.shape[1]
    dev = src.device
    tex = src.to(dtype) * _r(1 / 255, dtype)
    cols = torch.floor((torch.arange(WIDTH, dtype=torch.float64, device=dev) + 0.5) * w / WIDTH).long()
    up = tex[:, cols.clamp(0, w - 1)]  # NEAREST
    yiq = _times([up[..., 0], up[..., 1], up[..., 2]], RGB2YIQ, dtype)

    # pix_no = vTexCoord * TextureSize * (OutputSize / InputSize): the
    # pixel's centre in output pixels.
    px = torch.arange(WIDTH, dtype=dtype, device=dev)[None, :] + 0.5
    py = torch.arange(h, dtype=dtype, device=dev)[:, None] + 0.5
    cmf = _r(_r(4.0 * _r(PI, dtype), dtype) / 15.0, dtype)  # CHROMA_MOD_FREQ = 4 PI / 15
    chroma_phase = _r(PI, dtype) * (torch.remainder(py, 2.0) + float(frame_count % 2))
    mod_phase = chroma_phase + px * cmf
    i_mod, q_mod = torch.cos(mod_phase.double()).to(dtype), torch.sin(mod_phase.double()).to(dtype)

    y, i, q = yiq[0], yiq[1] * i_mod, yiq[2] * q_mod  # modulate
    y, i, q = _times([y, i, q], MIX, dtype)  # cross-talk
    return torch.stack([y, i * i_mod, q * q_mod], dim=-1)  # demodulate


def decode(signal, dtype=torch.float32):
    """Pass 1 before its store: the composite signal ``[h, W, 3]`` →
    ``pow(yiq2rgb(FIR(signal)), 1.25)`` ``[h, W / 2, 3]`` in ``dtype``."""
    h, w_in = signal.shape[0], signal.shape[1]
    dev = signal.device
    centre = 2 * torch.arange(w_in // 2, device=dev)  # texel under output pixel x: 2x

    def tap(k):
        return signal[:, (centre + k).clamp(0, w_in - 1)]

    weights = [torch.tensor([LUMA[i], CHROMA[i], CHROMA[i]], dtype=torch.float64, device=dev).to(dtype)
               for i in range(TAPS + 1)]
    acc = torch.zeros((h, w_in // 2, 3), dtype=dtype, device=dev)
    for i in range(TAPS):
        acc = acc + (tap(i - TAPS) + tap(TAPS - i)) * weights[i]
    acc = acc + tap(0) * weights[TAPS]
    rgb = _times([acc[..., 0], acc[..., 1], acc[..., 2]], YIQ2RGB, dtype)
    return torch.pow(torch.stack(rgb, dim=-1), _r(GAMMA, dtype))


def rows(out_w: int, out_h: int, h: int, dev):
    """The source row of each of ``out_h`` output rows of a ``out_w`` x
    ``out_h`` pass over ``h`` source rows, as the GL rasterizer's float32
    plane set-up puts the varying (the module's docstring)."""
    f32 = torch.float32
    ooa = torch.tensor(1.0, dtype=f32) / torch.tensor(float(out_w * out_h), dtype=f32)
    dady = torch.tensor(float(out_w), dtype=f32) * ooa
    a0 = dady * 0.5
    y = torch.arange(out_h, dtype=torch.float64, device=dev)
    coord = (dady.double().to(dev) * y + a0.double().to(dev)).to(f32)
    return torch.floor(coord * float(h)).long().clamp(0, h - 1)


def store(x):
    """The RGBA8 framebuffer's level of ``x``: NaN stores 0."""
    return torch.round(torch.nan_to_num(x, nan=0.0).clamp(0.0, 1.0) * 255.0)


def blit(tex, out_w: int, dtype):
    """The window's LINEAR, clamp_to_edge stretch of ``tex [H, W, 3]`` to
    ``out_w`` columns (the rows are the viewport's already)."""
    w = tex.shape[1]
    dev = tex.device
    u = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) / float(out_w)
    s = u * float(w) - 0.5
    x0 = torch.floor(s)
    f = (s - x0).to(dtype)[None, :, None]
    x0 = x0.long()
    return tex[:, x0.clamp(0, w - 1)] * (1.0 - f) + tex[:, (x0 + 1).clamp(0, w - 1)] * f


def render(src, frame_count: int, params: dict, out_hw, dtype=torch.float32):
    """One output frame: ``src`` u8 ``[h, w, 3]`` (a tensor on the device
    to compute on), FrameCount, the parameters (the preset has none),
    ``out_hw`` (OH, OW) → u8 ``[OH, OW, 3]``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    oh, ow = out_hw
    h = src.shape[0]
    rgb = decode(encode(src, frame_count, dtype), dtype)  # [h, WIDTH / 2, 3]
    rgb = rgb[rows(rgb.shape[1], oh, h, src.device)]  # the viewport's rows
    level = store(rgb)
    out = blit(level * _r(1 / 255, dtype), ow, dtype)
    return torch.round(out.float().clamp(0.0, 1.0) * 255.0).to(torch.uint8)
