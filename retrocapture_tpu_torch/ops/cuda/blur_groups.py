"""Warped multi-group 5x5 NEAREST-tap blur: the CUDA kernel and its plain
version.

Replaces ``retrocapture_tpu/ops/pallas/blur_groups.py:blur5x5_groups``,
which runs ``_blur_groups_call_v2`` (exact 5x5 weights, the default) or,
under ``RCTPU_BLUR=v1``, ``_blur_groups_call`` (rank-2 SVD weights). The
crt-mattias fragment sums 9 blur() groups x 25 NEAREST taps per output
pixel; every group contributes, to its output channel,

    sum_j sum_i W[j][i] * tex[row_j, col_i, channel]
    col_i = clamp(floor(((u + bx) + xo_i) * W), 0, W-1)   (rows likewise)

with the evaluator's f32 op order for the tap indices. The TPU kernels
rebuild that gather from VMEM bands, lane rotations and one-hot masks.
The kernel (``csrc/blur_groups.cu``) gathers each 64 x 16 output tile's
source footprint into shared memory and sums there, 4 pixels a thread,
with the group table in shared memory; a tile whose footprint does not
fit (a wild warp, non-finite coordinates) sums from global memory in the
same kernel and counts in ``wide_tiles``. v1 and v2 differ only in the
5x5 weight table the host builds. The plain version runs the same loop
with torch gathers in the same order, so the two agree bit for bit.

The numpy plan helpers (``BlurGroup``, ``_rank2``, ``_static_plan``,
``_static_plan_v2``) are copied from the reference, so that
``blur_groups_fits`` engages exactly where the reference does. Its TPU
platform test becomes "the tensor is on the CPU or a CUDA card"; the
VMEM and drift limits are limits of the TPU design, kept for now.

``blur5x5_groups`` launches the kernel for a CUDA tensor and takes the
plain version only for a CPU tensor. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from retrocapture_tpu_torch.policy import ifloor32, upload

__all__ = [
    "blur5x5_groups",
    "blur5x5_groups_plain",
    "blur_groups_fits",
    "weight_tables",
    "BlurGroup",
    "LAUNCHES",
    "wide_tiles",
]

LAUNCHES = 0
# device -> int32 [1]: the tiles the kernel summed from global memory.
_WIDE: dict = {}

TX = 128  # output pixels per tile row (lane dim; take_along_axis is
# single-vreg along the gather dim, so TX cannot exceed 128)
TY = 8  # output rows per tile (TY=16 measured neutral: cost is per-row)
_KB_CAP = 32  # max band rows per channel window
_VMEM_TEX_BYTES = 6 * 2**20


class BlurGroup:
    """One blur() call: output channel, texture channel, base uv offset,
    per-tap uv offsets (5 x, 5 y), the 5x5 weight matrix (row-major
    [j][i]) and a scalar output scale (folded into the weights)."""

    __slots__ = ("channel", "bx", "by", "xo", "yo", "weights", "scale")

    def __init__(self, channel, bx, by, xo, yo, weights, scale=1.0):
        self.channel = int(channel)
        self.bx = float(bx)
        self.by = float(by)
        self.xo = tuple(float(x) for x in xo)  # uv units
        self.yo = tuple(float(y) for y in yo)
        self.weights = np.asarray(weights, np.float64)
        self.scale = float(scale)


def _rank2(weights):
    """Rank-2 SVD factors [(ax, ay), (ax2, ay2)]: out ~ sum_m ay_m ⊗ ax_m."""
    u, s, vt = np.linalg.svd(weights)
    facs = []
    for m in range(2):
        facs.append(
            (
                (np.sign(s[m]) * np.abs(s[m]) ** 0.5 * vt[m]).astype(np.float32),
                (np.abs(s[m]) ** 0.5 * u[:, m]).astype(np.float32),
            )
        )
    w2 = sum(np.outer(ay, ax) for ax, ay in facs)
    return facs, float(np.abs(weights - w2).max())


def _static_plan(groups, w, h):
    """Per-group static tap data + per-channel tau sets and row windows."""
    chans = sorted({g.channel for g in groups})
    plan = {ch: {"taus": set(), "mmin": 10**9, "mmax": -(10**9), "groups": []} for ch in chans}
    for g in groups:
        facs, resid = _rank2(g.weights * g.scale)
        xi = []  # per x-tap: (TLO, xo as f32)
        for xo in g.xo:
            c = (g.bx + xo) * w
            tlo = int(np.floor(c))
            xi.append((tlo, np.float32(xo)))
            plan[g.channel]["taus"].update((tlo, tlo + 1))
        yj = []
        for yo in g.yo:
            c = (g.by + yo) * h
            slo = int(np.floor(c))
            yj.append((slo, np.float32(yo)))
            plan[g.channel]["mmin"] = min(plan[g.channel]["mmin"], slo)
            plan[g.channel]["mmax"] = max(plan[g.channel]["mmax"], slo + 1)
        plan[g.channel]["groups"].append(
            {"g": g, "facs": facs, "xi": xi, "yj": yj}
        )
    for ch in chans:
        plan[ch]["taus"] = sorted(plan[ch]["taus"])
        plan[ch]["tmin"] = plan[ch]["taus"][0]
        plan[ch]["tmax"] = plan[ch]["taus"][-1]
        # Band rows: tap row window + descent/bend margin, 8-aligned.
        # Margin covers the TY-row tile descent (TY*h/oh*1.3, <= 8 for
        # TY=16 at upscale ratios >= 3) plus bend slack; blur_groups_fits
        # re-checks the margin against the actual geometry and rejects
        # when it is insufficient.
        win = plan[ch]["mmax"] - plan[ch]["mmin"] + 1
        plan[ch]["kb"] = min(((win + 9 + 7) // 8) * 8, _KB_CAP)
    return plan


def _static_plan_v2(groups, w, h, oh, ow, max_dudv=None):
    """Per-group static plan: tap bases, tau sets (+-1/+2 routing
    margin), and the narrow row-window height R. Returns None when any
    group's geometry cannot satisfy the window invariants (caller falls
    back / rejects via blur_groups_fits).

    ``max_dudv``: worst-case |du/dv| of the warp (uv units per v unit),
    supplied by the caller from its analytic warp bound (for crt-mattias:
    the CURVATURE=1 curve slope — the runtime CURVATURE parameter only
    interpolates toward that curve, so it is the hard ceiling). v2's tau
    routing gathers against row 0's column base and covers per-row drift
    only via the {-1..+2} candidate window; the plan REJECTS (returns
    None) when the worst-case per-tile column drift could exceed that
    margin, instead of silently routing to the wrong texel. ``None``
    means the caller vouches for drift <= +-1 texel per TY-row tile."""
    descent = int(np.ceil(TY * (h / oh) * 1.3)) + 1
    span = TX * (w / ow) * 1.3 + 4
    if max_dudv is not None:
        # Column drift across a TY-row output tile, in source texels.
        # Candidates {-1..+2} around base rel in {0, 1} tolerate 1.0
        # texel of drift each way; keep 0.25 texel of floor-rounding
        # fuzz.
        drift_texels = float(max_dudv) * (TY - 1) / float(oh) * float(w)
        if drift_texels > 0.75:
            return None
    plan = []
    for g in groups:
        w32 = (g.weights * g.scale).astype(np.float32)
        xi = []
        for xo in g.xo:
            c = (np.float32(g.bx) + np.float32(xo)) * np.float32(w)
            xi.append((int(np.floor(c)), np.float32(xo)))
        yj = []
        for yo in g.yo:
            c = (np.float32(g.by) + np.float32(yo)) * np.float32(h)
            yj.append((int(np.floor(c)), np.float32(yo)))
        taus = sorted({t + k for t, _ in xi for k in (-1, 0, 1, 2)})
        slos = [s for s, _ in yj]
        win = (max(slos) + 1) - min(slos) + 1
        r_g = ((win + descent + 3 + 7) // 8) * 8
        if r_g > _KB_CAP:
            return None
        # Rotated-window coverage: tile source span + routed tau spread.
        if span + (taus[-1] - taus[0]) > TX - 8:
            return None
        plan.append(
            {
                "g": g,
                "w32": w32,
                "xi": xi,
                "yj": yj,
                "taus": taus,
                "tmin": taus[0],
                "R": r_g,
                "slo_min": min(slos),
            }
        )
    return plan


def _formulation() -> str:
    mode = os.environ.get("RCTPU_BLUR", "v2")
    if mode == "v3":
        raise NotImplementedError(
            "RCTPU_BLUR=v3 (the bf16 variant of the v2 TPU kernel) is not ported: ROADMAP queue 1"
        )
    return "v1" if mode == "v1" else "v2"


def blur_groups_fits(tex_shape, out_shape, groups, max_dudv=None, *, device) -> bool:
    """Static feasibility, the reference's geometric checks unchanged:
    VMEM-resident texture; each channel's tap window within one 128-lane
    rotated window; row window within the KB-row band; and (v2, when the
    caller supplies its warp-slope bound ``max_dudv``) the worst-case
    per-tile column drift within the tau candidate margin. The
    reference's last check (a TPU backend) becomes: ``device`` is the
    CPU (plain version) or a CUDA card (the kernel)."""
    h, w, c = tex_shape
    oh, ow = out_shape
    hp = ((h + 7) // 8) * 8
    wp = ((w + 2 * TX - 1) // (2 * TX)) * (2 * TX)
    if hp * wp * c * 4 > _VMEM_TEX_BYTES:
        return False
    if os.environ.get("RCTPU_BLUR", "v2") != "v1":
        if _static_plan_v2(groups, w, h, oh, ow, max_dudv) is None:
            return False
    else:
        plan = _static_plan(groups, w, h)
        # x: tile source span (with curvature slack x1.3) + tau spread
        # must fit the rotated TX-lane window
        span = TX * (w / ow) * 1.3 + 4
        descent = TY * (h / oh) * 1.3 + 3
        for ch, p in plan.items():
            if span + (p["tmax"] - p["tmin"]) > TX - 8:
                return False
            # y: tap row window + tile descent (TY rows + slack) + bend
            if (p["mmax"] - p["mmin"]) + descent > p["kb"] - 1:
                return False
    return torch.device(device).type in ("cpu", "cuda")


def weight_tables(groups, formulation: str) -> list[np.ndarray]:
    """Each group's f32 5x5 weight table [j][i], scale folded: v2 the
    exact ``(weights * scale).astype(f32)`` (reference :482); v1 the
    rank-2 reconstruction ``f32(ay0[j]*ax0[i]) + f32(ay1[j]*ax1[i])``
    of ``_rank2(weights * scale)``."""
    out = []
    for g in groups:
        if formulation == "v1":
            ((ax0, ay0), (ax1, ay1)), _ = _rank2(g.weights * g.scale)
            out.append(np.outer(ay0, ax0) + np.outer(ay1, ax1))
        else:
            out.append((g.weights * g.scale).astype(np.float32))
    return out


def _plain(tex, u, v, params, channels):
    """The plain version over the kernel's own group table (``_group_params``):
    ``tex [B, H, W, C]`` f32, ``u, v [HO, WO]`` f32, ``params [G, 37]``,
    ``channels`` each group's texture channel → ``[n channels, B, HO, WO]``
    in sorted channel order. Per channel, the groups in list order, j then
    i, each tap ``acc + W[j][i] * texel`` in f32 without contraction: the
    kernel's order."""
    b, h, w, _ = tex.shape
    ho, wo = u.shape
    chans = sorted(set(channels))
    acc = {ch: torch.zeros((b, ho * wo), dtype=torch.float32, device=tex.device) for ch in chans}
    planes = {ch: tex[..., ch].reshape(b, h * w) for ch in chans}
    for p, ch in zip(params, channels):
        ug = u + p[0]
        vg = v + p[1]
        cols = [ifloor32((ug + xo) * float(w)).clamp(0, w - 1).long() for xo in p[2:7]]
        rows = [ifloor32((vg + yo) * float(h)).clamp(0, h - 1).long() for yo in p[7:12]]
        plane = planes[ch]
        a = acc[ch]
        for j, r in enumerate(rows):
            for i, c in enumerate(cols):
                a = a + p[12 + 5 * j + i] * plane[:, (r * w + c).reshape(-1)]
        acc[ch] = a
    return torch.stack([acc[ch].reshape(b, ho, wo) for ch in chans])


def blur5x5_groups_plain(tex, u, v, groups, tables):
    """Plain torch version: ``tex [B, H, W, C]`` f32, ``u, v [HO, WO]``
    f32 → ``{channel: [B, HO, WO]}``."""
    params, _, chans = _group_params(groups, tables, tex.device)
    out = _plain(tex, u, v, params, [g.channel for g in groups])
    return {ch: out[k] for k, ch in enumerate(chans)}


def _group_params(groups, tables, device):
    """The kernel's per-group table: [bx, by, xo x5, yo x5, W x25] f32,
    and the texture channel and output slot of each group."""
    chans = sorted({g.channel for g in groups})
    rows = [
        np.concatenate([[g.bx, g.by], g.xo, g.yo, wt.reshape(-1)]).astype(np.float32)
        for g, wt in zip(groups, tables)
    ]
    params = upload(np.stack(rows), device)
    chan = upload(np.array([[g.channel, chans.index(g.channel)] for g in groups], np.int32), device)
    return params, chan, chans


@torch.library.custom_op("rctpu::blur_groups", mutates_args=(), device_types="cuda")
def _blur_groups_op(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor, params: torch.Tensor, chan: torch.Tensor,
                    channels: list[int]) -> torch.Tensor:
    """``tex [B, H, W, C]`` f32, ``u, v [HO, WO]`` f32, the group table
    ``params``, ``chan`` (each group's texture channel and output slot) on
    tex's device, ``channels`` each group's texture channel → ``[n
    channels, B, HO, WO]``: the kernel on a card."""
    from retrocapture_tpu_torch.ops.cuda._build import load

    global LAUNCHES
    t4 = tex.contiguous()
    uu, vv = u.contiguous(), v.contiguous()
    b, h, w, c = t4.shape
    ho, wo = u.shape
    nch = len(set(channels))
    out = torch.empty((nch, b, ho, wo), dtype=torch.float32, device=t4.device)
    if out.numel() == 0:
        return out
    wide = _WIDE.get(t4.device)
    if wide is None:
        wide = _WIDE[t4.device] = torch.zeros(1, dtype=torch.int32, device=t4.device)
    rc = load("blur_groups")(
        t4.data_ptr(), uu.data_ptr(), vv.data_ptr(), params.data_ptr(), chan.data_ptr(), out.data_ptr(),
        wide.data_ptr(), b, h, w, c, ho, wo, len(channels), nch,
        torch.cuda.current_stream(t4.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"blur_groups kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


@_blur_groups_op.register_kernel("cpu")
def _blur_groups_cpu(tex, u, v, params, chan, channels):
    return _plain(tex, u, v, params, channels)


@_blur_groups_op.register_fake
def _blur_groups_fake(tex, u, v, params, chan, channels):
    return tex.new_empty((len(set(channels)), tex.shape[0]) + tuple(u.shape))


@_blur_groups_op.register_vmap
def _blur_groups_vmap(info, in_dims, tex, u, v, params, chan, channels):
    td = in_dims[0]
    if all(d is None for d in in_dims[1:5]):
        # Shared coordinates and groups: the batch's textures in one launch
        # (the reference's rule, blur_groups.py:191-215).
        t = tex.movedim(td, 0)
        out = _blur_groups_op(t.reshape((-1,) + tuple(t.shape[2:])), u, v, params, chan, channels)
        return out.reshape((out.shape[0],) + tuple(t.shape[:2]) + tuple(out.shape[2:])), 1
    args = (tex, u, v, params, chan)
    outs = [
        _blur_groups_op(*(x if d is None else x.select(d, i) for x, d in zip(args, in_dims)), channels)
        for i in range(info.batch_size)
    ]
    return torch.stack(outs, dim=1), 1


def wide_tiles(reset: bool = False) -> int:
    """The 64 x 16 output tiles (one frame each) that the kernel has summed
    from global memory since the last reset, over every card: tiles whose
    source footprint does not fit its shared-memory budget or that hold a
    non-finite or huge coordinate. Reads the counters (a synchronising
    copy); ``reset`` zeroes them."""
    n = sum(int(t.item()) for t in _WIDE.values())
    if reset:
        for t in _WIDE.values():
            t.zero_()
    return n


def blur5x5_groups(tex, u, v, groups):
    """``tex [H, W, C]`` or ``[B, H, W, C]`` f32 (pre-transformed values),
    ``u, v [HO, WO]`` f32 base warp shared by the batch → ``{channel:
    [(B,) HO, WO] f32}`` with each group's scale folded. ``RCTPU_BLUR``
    picks the weights as the reference does: v2 (default) exact, v1
    rank-2. A CUDA tensor launches the kernel; a CPU tensor takes the
    plain version. Both sit behind the operator ``rctpu::blur_groups``,
    whose batching rule launches once for a batch of textures that shares
    the coordinates and once a frame otherwise."""
    if tex.dtype != torch.float32:
        raise TypeError(f"blur5x5_groups: tex must be float32, got {tex.dtype}")
    if tex.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"blur5x5_groups: no kernel for device {tex.device}")
    squeeze = tex.dim() == 3
    t4 = tex[None] if squeeze else tex
    if t4.dim() != 4:
        raise ValueError(f"blur5x5_groups: tex must be [H,W,C] or [B,H,W,C], got {tuple(tex.shape)}")
    if u.shape != v.shape or u.dim() != 2:
        raise ValueError(f"blur5x5_groups: u, v must share one [HO, WO] shape, got {tuple(u.shape)}, {tuple(v.shape)}")
    if max(g.channel for g in groups) >= t4.shape[-1]:
        raise ValueError(f"blur5x5_groups: a group reads a channel beyond C={t4.shape[-1]}")
    params, chan, chans = _group_params(groups, weight_tables(groups, _formulation()), t4.device)
    if t4.is_cuda:
        if len(chans) > 4:
            raise ValueError(f"blur5x5_groups: the kernel writes at most 4 channels, got {len(chans)}")
        if t4.shape[-1] > 4:
            raise ValueError(f"blur5x5_groups: the kernel takes at most 4 texture channels, got {t4.shape[-1]}")
    out = _blur_groups_op(
        t4, u.to(torch.float32), v.to(torch.float32), params, chan, [g.channel for g in groups]
    )
    return {ch: out[k, 0] if squeeze else out[k] for k, ch in enumerate(chans)}
