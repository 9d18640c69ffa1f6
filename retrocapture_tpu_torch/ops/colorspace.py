"""Color-space and framebuffer-format transforms (torch).

Covers the reference's FBO formats (ShaderEngine::createFramebuffer,
ShaderEngine.cpp:2872-2923 — RGBA8 / RGBA32F / SRGB8_ALPHA8) and the
CPU pixel-format converters (utils/PixelFormatConverter, BT.601) that the
first pass fuses in (SURVEY.md §7 step 6).

GL sRGB filtering linearizes each texel *before* bilinear blending, so
storing ``decode(quantize(encode(x)))`` as linear float and filtering
normally is bit-equivalent to sampling an SRGB8 texture.

Every function takes and returns tensors; the tables below are uploaded
to the input's device.
"""

from __future__ import annotations

import numpy as np
import torch

from retrocapture_tpu_torch.policy import upload

__all__ = [
    "quantize_rgba8",
    "srgb_store_rgb",
    "framebuffer_store",
    "yuyv_to_rgb",
    "nv12_to_rgb",
    "uyvy_to_rgb",
    "rgb_to_unit_float",
]


# llvmpipe float->sRGB8 store transitions, probed from the GL oracle
# (Mesa llvmpipe) 2026-08-18 by every-ulp scans around each code
# boundary. The driver's conversion (lp_bld_format_srgb.c) is a
# piecewise-linear fixed-point approximation of IEC 61966-2-1 that is
# locally NON-monotone: around most boundaries the stored code rises,
# dips back, and rises again within a few thousand ulps. The stored
# code is exactly  #{U <= x} - #{D <= x}  over these up/down
# transition tables (verified on 650k random inputs, 99.98% bit-exact;
# the residue is unfound wiggles beyond the scanned windows). The exact
# IEC encode the engine previously used picked a one-off code on ~7% of
# stored pixels, which dominated crt-royale's chain parity
# (srgb_framebuffer on most of its passes).
_SRGB_UP = np.array([
    0.00015176351, 0.000455290457, 0.000758817478, 0.00106234441, 0.00136587152, 0.00166939839,
    0.00197292562, 0.00227645226, 0.0025799796, 0.00288350624, 0.00323728775, 0.00355475675,
    0.00389194675, 0.00424473314, 0.00461733481, 0.00500685675, 0.00541602867, 0.00541719701,
    0.00584496744, 0.00628944673, 0.00676129479, 0.00725119049, 0.00725179352, 0.00776066212,
    0.00828682259, 0.00883908104, 0.00940257963, 0.010000539, 0.0100039756, 0.0106097572,
    0.011249288, 0.0119054159, 0.0125833349, 0.0132811107, 0.0140044633, 0.0140077006,
    0.0147519056, 0.0147554055, 0.0155277299, 0.0163191017, 0.0171306469, 0.0171372183,
    0.0179700162, 0.0188379306, 0.0188455079, 0.0197276119, 0.0197316706, 0.0206417497,
    0.0206504427, 0.0215806328, 0.0225461312, 0.0235201027, 0.0245460961, 0.02455361,
    0.0255712382, 0.0255792048, 0.026625663, 0.0266277827, 0.0277204216, 0.0288280603,
    0.0299664568, 0.0299715232, 0.0311340038, 0.0323314853, 0.0335522704, 0.0347861573,
    0.034792494, 0.0360576212, 0.0373493172, 0.0373634212, 0.0386595242, 0.0386726558,
    0.0400349721, 0.0414081886, 0.0414237119, 0.0428063832, 0.0428177007, 0.044248566,
    0.0442667492, 0.0442849472, 0.0457090139, 0.0457186364, 0.0471954234, 0.0487428904,
    0.0502599701, 0.0502654724, 0.0518641584, 0.0534338653, 0.0534415729, 0.0550692752,
    0.0567470305, 0.0584505759, 0.0601582266, 0.0618762076, 0.0618912429, 0.0636989251,
    0.0637247488, 0.0654704794, 0.0655025244, 0.0673382357, 0.0691505373, 0.0691860616,
    0.0710896552, 0.0711174235, 0.0730160475, 0.0749709457, 0.0769463554, 0.0789634138,
    0.0789959282, 0.0810274854, 0.0810612813, 0.0831042752, 0.0852389634, 0.0873812437,
    0.0895496756, 0.0917297676, 0.0917433351, 0.0940124318, 0.0962214023, 0.098549746,
    0.0985799655, 0.100876145, 0.100891791, 0.10324046, 0.103272863, 0.105627514,
    0.108125634, 0.110511072, 0.110546954, 0.113024756, 0.113043308, 0.115554482,
    0.118107952, 0.120714225, 0.120755188, 0.123336494, 0.123378806, 0.125949278,
    0.125982016, 0.128635198, 0.128669009, 0.13140662, 0.134131432, 0.134167418,
    0.136899337, 0.139746606, 0.139772117, 0.142657727, 0.142703861, 0.145462096,
    0.148380071, 0.15139167, 0.154277459, 0.154307052, 0.15732348, 0.157367751,
    0.160446882, 0.16351974, 0.163584337, 0.166691586, 0.169864342, 0.173026651,
    0.176323026, 0.179500461, 0.182836056, 0.182874233, 0.186177909, 0.189625278,
    0.192900568, 0.196312279, 0.199868977, 0.203346074, 0.203390852, 0.206893206,
    0.206916183, 0.210472882, 0.214072704, 0.214169472, 0.217760623, 0.217785433,
    0.221490189, 0.225284681, 0.228963017, 0.232768968, 0.232796386, 0.236638173,
    0.240450859, 0.240479648, 0.244445786, 0.248242781, 0.248303175, 0.252410501,
    0.25247243, 0.25646922, 0.260407895, 0.260537714, 0.26452902, 0.268694818,
    0.272830635, 0.272963017, 0.27695784, 0.281236291, 0.281321764, 0.285555124,
    0.285666943, 0.289943635, 0.294146061, 0.294252843, 0.298522562, 0.298642069,
    0.302925855, 0.303015739, 0.307502866, 0.312140793, 0.316705376, 0.321262747,
    0.321329415, 0.325863928, 0.325932056, 0.330443621, 0.335134953, 0.33527711,
    0.339981169, 0.344843298, 0.349501491, 0.349652857, 0.354348928, 0.359315574,
    0.359473377, 0.364226013, 0.364279687, 0.36922884, 0.374333411, 0.379115939,
    0.379229933, 0.384375453, 0.389356554, 0.389475197, 0.394720674, 0.39484179,
    0.399813622, 0.399937093, 0.405095756, 0.410381317, 0.410445511, 0.415730357,
    0.415795803, 0.421014607, 0.426459402, 0.426554382, 0.431992441, 0.437436968,
    0.4375076, 0.443052024, 0.443124026, 0.448673904, 0.454222262, 0.459808499,
    0.465498537, 0.471127182, 0.471285105, 0.47700876, 0.477089196, 0.482782423,
    0.488607407, 0.494499505, 0.500388384, 0.500518084, 0.506299317, 0.506431282,
    0.512369514, 0.518424809, 0.518591881, 0.52472049, 0.530707181, 0.530890882,
    0.536957026, 0.537149251, 0.543286443, 0.543482065, 0.549305618, 0.549591839,
    0.555771947, 0.562218666, 0.568567991, 0.574994206, 0.581419945, 0.588060737,
    0.594433308, 0.601178944, 0.60765326, 0.614549756, 0.614771307, 0.621338725,
    0.627851367, 0.627972841, 0.634911716, 0.641414285, 0.641665161, 0.648662388,
    0.655537367, 0.662347734, 0.669192076, 0.669459522, 0.676199734, 0.676335514,
    0.683809519, 0.690615177, 0.697888792, 0.704856813, 0.705135942, 0.712286413,
    0.712580025, 0.720101655, 0.720250845, 0.727333307, 0.727636278, 0.734638155,
    0.734945714, 0.742009699, 0.749847829, 0.757092357, 0.764915049, 0.772294343,
    0.78003329, 0.787495911, 0.787666559, 0.795512259, 0.803078771, 0.811363876,
    0.811542332, 0.819038749, 0.826944113, 0.834912598, 0.835098863, 0.842972755,
    0.850712001, 0.859088182, 0.867394567, 0.87578094, 0.875981092, 0.883603752,
    0.884009421, 0.891906619, 0.892112315, 0.900519907, 0.909038007, 0.916931391,
    0.917145789, 0.926073849, 0.933846951, 0.943126559, 0.951553285, 0.951666653,
    0.959849298, 0.959964156, 0.968509495, 0.977300823, 0.986047804, 0.994996011
], np.float32)
_SRGB_DOWN = np.array([
    0.00541687012, 0.0072517395, 0.0100021362, 0.0140075684, 0.014755249, 0.0171356201,
    0.0188446045, 0.0197296143, 0.0206451416, 0.0245513916, 0.0255737305, 0.0266265869,
    0.0299682617, 0.0347900391, 0.0373535156, 0.0386657715, 0.0414123535, 0.0428161621,
    0.0442504883, 0.0442810059, 0.045715332, 0.0502624512, 0.0534362793, 0.0618896484,
    0.0637207031, 0.0654907227, 0.069152832, 0.071105957, 0.0789794922, 0.0810546875,
    0.0917358398, 0.0985717773, 0.100891113, 0.103271484, 0.110534668, 0.113037109,
    0.120727539, 0.123352051, 0.125976562, 0.128662109, 0.134155273, 0.139770508,
    0.142700195, 0.154296875, 0.157348633, 0.163574219, 0.182861328, 0.203369141,
    0.20690918, 0.214111328, 0.217773438, 0.232788086, 0.240478516, 0.248291016,
    0.252441406, 0.260498047, 0.272949219, 0.28125, 0.285644531, 0.294189453,
    0.298583984, 0.302978516, 0.321289062, 0.325927734, 0.335205078, 0.349609375,
    0.359375, 0.364257812, 0.379150391, 0.389404297, 0.394775391, 0.399902344,
    0.410400391, 0.415771484, 0.426513672, 0.4375, 0.443115234, 0.471191406,
    0.477050781, 0.500488281, 0.506347656, 0.518554688, 0.530761719, 0.537109375,
    0.543457031, 0.549316406, 0.614746094, 0.627929688, 0.641601562, 0.669433594,
    0.676269531, 0.705078125, 0.712402344, 0.720214844, 0.727539062, 0.734863281,
    0.787597656, 0.811523438, 0.834960938, 0.875976562, 0.883789062, 0.892089844,
    0.916992188, 0.951660156, 0.959960938
], np.float32)

# Exact IEC decode of each code, computed in f64 once — bit-identical
# to the oracle harness's readback decode (parity/oracle.py decodes the
# f32 readback k/255 promoted to f64, so quantize to f32 first).
_k = (np.arange(256, dtype=np.float64) / 255.0).astype(np.float32).astype(np.float64)
_SRGB_DEC = np.where(
    _k <= 0.04045, _k / 12.92, ((_k + 0.055) / 1.055) ** 2.4
).astype(np.float32)
del _k


def quantize_rgba8(x):
    """Clamp to [0,1] and quantize to 8-bit levels (RGBA8 FBO round
    trip). NaN flushes to 0 like a GL UNORM store. ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    x = torch.where(torch.isnan(x), 0.0, x)
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0) * (1.0 / 255.0)


def srgb_store_rgb(x):
    """Linear RGB -> the linear value a later pass samples after an
    SRGB8 framebuffer store, matching the llvmpipe driver's quantizer:
    code = #{U <= x} - #{D <= x} over the probed transition tables,
    then the exact IEC decode shared with the GL oracle. NaN stores 0
    like a GL UNORM store."""
    x = torch.where(torch.isnan(x), 0.0, torch.clamp(x, 0.0, 1.0))
    up = upload(_SRGB_UP, x.device)
    down = upload(_SRGB_DOWN, x.device)
    code = torch.searchsorted(up, x.contiguous(), right=True) - torch.searchsorted(
        down, x.contiguous(), right=True
    )
    return upload(_SRGB_DEC, x.device)[code]


def framebuffer_store(x, *, float_framebuffer: bool, srgb_framebuffer: bool):
    """Apply the pass-output framebuffer format to a linear [H,W,4] tensor,
    returning what a later pass would observe when sampling the FBO."""
    if float_framebuffer:
        return x
    if srgb_framebuffer:
        rgb = srgb_store_rgb(x[..., :3])
        a = quantize_rgba8(x[..., 3:4])
        return torch.cat([rgb, a], dim=-1)
    return quantize_rgba8(x)


# ---------------------------------------------------------------------------
# BT.601 YUV → RGB (limited range), matching utils/PixelFormatConverter.

_BT601 = np.array(
    [
        [1.164, 0.0, 1.596],
        [1.164, -0.392, -0.813],
        [1.164, 2.017, 0.0],
    ],
    np.float32,
)


def _ycbcr_to_rgb(y, cb, cr):
    y = y - 16.0
    cb = cb - 128.0
    cr = cr - 128.0
    m = _BT601
    r = m[0, 0] * y + m[0, 2] * cr
    g = m[1, 0] * y + m[1, 1] * cb + m[1, 2] * cr
    b = m[2, 0] * y + m[2, 1] * cb
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.clamp(rgb * (1.0 / 255.0), 0.0, 1.0)


def yuyv_to_rgb(raw, width: int, height: int):
    """raw: uint8 [..., H, W*2] YUYV interleaved rows (Y0 U Y1 V) →
    float32 [..., H, W, 3]."""
    raw = raw.reshape(raw.shape[:-2] + (height, width // 2, 4)).to(torch.float32)
    y0 = raw[..., 0]
    u = raw[..., 1]
    y1 = raw[..., 2]
    v = raw[..., 3]
    y = torch.stack([y0, y1], dim=-1).reshape(raw.shape[:-2] + (width,))
    u2 = torch.repeat_interleave(u, 2, dim=-1)
    v2 = torch.repeat_interleave(v, 2, dim=-1)
    return _ycbcr_to_rgb(y, u2, v2)


def uyvy_to_rgb(raw, width: int, height: int):
    """raw: uint8 [..., H, W*2] UYVY interleaved → float32 [..., H, W, 3]."""
    raw = raw.reshape(raw.shape[:-2] + (height, width // 2, 4)).to(torch.float32)
    u = raw[..., 0]
    y0 = raw[..., 1]
    v = raw[..., 2]
    y1 = raw[..., 3]
    y = torch.stack([y0, y1], dim=-1).reshape(raw.shape[:-2] + (width,))
    u2 = torch.repeat_interleave(u, 2, dim=-1)
    v2 = torch.repeat_interleave(v, 2, dim=-1)
    return _ycbcr_to_rgb(y, u2, v2)


def nv12_to_rgb(y_plane, uv_plane, width: int, height: int):
    """y: uint8 [..., H, W]; uv: uint8 [..., H//2, W] interleaved U,V →
    float32 [..., H, W, 3]."""
    y = y_plane.to(torch.float32)
    uv = uv_plane.reshape(uv_plane.shape[:-2] + (height // 2, width // 2, 2)).to(
        torch.float32
    )
    u = torch.repeat_interleave(torch.repeat_interleave(uv[..., 0], 2, dim=-1), 2, dim=-2)
    v = torch.repeat_interleave(torch.repeat_interleave(uv[..., 1], 2, dim=-1), 2, dim=-2)
    return _ycbcr_to_rgb(y, u, v)


def rgb_to_unit_float(frame):
    """uint8 [..., 3] → float32 [..., 3] in [0, 1]."""
    return frame.to(torch.float32) * (1.0 / 255.0)
