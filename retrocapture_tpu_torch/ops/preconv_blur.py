"""Phase-supersampled pre-convolution for warped multi-tap blurs.

The port of ``retrocapture_tpu/ops/pallas/preconv_blur.py``, the
``RCTPU_MATTIAS=preconv`` lowering of crt-mattias's 9-group x 25-tap
blur. For one blur group the tap column is ``clip(floor(z + A_i))`` with
``z = u*W`` shared by every tap and ``A_i = (bx + xo_i)*W`` a constant,
so the 25-tap sum is piecewise-constant in ``z`` on at most 6 subcells
per texel and axis. The blur becomes one texel lookup in a
subcell-supersampled pre-convolved texture::

    Qfine[(r*SY + iy), (s*SX + ix)] = sum_k  table[iy, ix, k] * P[r+dr_k, s+ds_k]

built at source resolution (one einsum per group, as the reference
leaves it to XLA), and one warped NEAREST sample per group and output
pixel, taken through the port's ``warp_sample`` (the CUDA kernel on the
card). Texture edges are exact through ``_PAD`` edge-replicated texels.

Exactness: identical to the direct blur up to f32 rounding order on
``z + A`` vs ``(u + bx + xo) * W``, which can flip a tap where a
coordinate sits within ulps of a texel boundary.

``plan_group``, ``_AxisPlan`` and ``GroupPlan`` are numpy, copied from the
reference; ``blur_preconv_fits`` is its predicate (the TPU warp
sampler's VMEM residency), kept as it is so that the port takes this
path exactly where the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from retrocapture_tpu_torch.policy import ifloor32, upload

__all__ = [
    "GroupPlan", "plan_group", "preconv_texture", "subcell_coords", "group_samples", "blur_preconv",
    "blur_preconv_fits",
]

_PAD = 4  # edge texels; covers |A| <= 4 (mattias ghost blur: |A| ~ 3.5)

# The reference's warp sampler's band grid and residency budget
# (ops/pallas/warp_sample.py KB, XB), used by blur_preconv_fits.
_KB = 8
_XB = 128


class _AxisPlan:
    """One axis of one group: per-tap integer base offsets K, sorted
    breakpoint thresholds ts (frac(z) >= ts[k] bumps the subcell), and
    for each of the len(ts)+1 subcells the per-tap relative offset."""

    __slots__ = ("ts", "rel", "n")

    def __init__(self, A):  # A: per-tap real offsets (f64)
        A = [float(a) for a in A]
        K = [int(np.floor(a)) for a in A]
        fr = [a - k for a, k in zip(A, K)]
        # tap i fires +1 when frac(z) >= 1 - frac(A_i)  (frac(A) == 0
        # never fires: offset is exactly integer)
        raw = [1.0 - f for f in fr if f > 0.0]
        ts = sorted(set(np.float32(t) for t in raw if 0.0 < t < 1.0))
        self.ts = np.asarray(ts, np.float32)
        self.n = len(ts) + 1
        # rel[cell][tap] = K_i + 1[threshold_i <= lower_bound(cell)]
        self.rel = []
        for cell in range(self.n):
            lo = np.float32(0.0) if cell == 0 else ts[cell - 1]
            self.rel.append(
                [
                    k + (1 if (a - k) > 0.0 and np.float32(1.0 - (a - k)) <= lo else 0)
                    for a, k in zip(A, K)
                ]
            )


class GroupPlan:
    """Host-side plan for one blur group on one texture shape."""

    __slots__ = (
        "channel", "sy", "sx", "ty", "tx", "table", "droffs", "dsoffs", "pad"
    )

    def __init__(self, channel, ax: _AxisPlan, ay: _AxisPlan, weights, scale):
        self.channel = int(channel)
        self.sy, self.sx = ay.n, ax.n
        self.ty, self.tx = ay.ts, ax.ts
        self.pad = _PAD
        # Collect the distinct (dr, ds) offsets used across all cells.
        offs = sorted(
            {
                (dr, ds)
                for cy in range(ay.n)
                for cx in range(ax.n)
                for dr in ay.rel[cy]
                for ds in ax.rel[cx]
            }
        )
        self.droffs = np.asarray([o[0] for o in offs], np.int32)
        self.dsoffs = np.asarray([o[1] for o in offs], np.int32)
        idx = {o: i for i, o in enumerate(offs)}
        w64 = np.asarray(weights, np.float64) * float(scale)
        table = np.zeros((ay.n, ax.n, len(offs)), np.float64)
        for cy in range(ay.n):
            for cx in range(ax.n):
                for j, dr in enumerate(ay.rel[cy]):
                    for i, ds in enumerate(ax.rel[cx]):
                        table[cy, cx, idx[(dr, ds)]] += w64[j, i]
        self.table = table.astype(np.float32)

    def q_shape(self, h: int, w: int) -> tuple[int, int]:
        return (h + 2 * self.pad) * self.sy, (w + 2 * self.pad) * self.sx


def plan_group(group, w: int, h: int) -> GroupPlan:
    """group: ops.pallas.blur_groups.BlurGroup (bx/by base uv offset,
    xo/yo per-tap uv offsets, 5x5 weights, scale)."""
    ax = _AxisPlan([(group.bx + xo) * w for xo in group.xo])
    ay = _AxisPlan([(group.by + yo) * h for yo in group.yo])
    return GroupPlan(group.channel, ax, ay, group.weights, group.scale)


def preconv_texture(plane: torch.Tensor, gp: GroupPlan) -> torch.Tensor:
    """plane [h, w] f32 (pre-transformed source channel) → Qfine
    [(h+2p)*SY, (w+2p)*SX] f32: the shifted, edge-padded stack
    contracted with the subcell table in one f32 einsum."""
    h, w = plane.shape
    p = gp.pad
    hp, wp = h + 2 * p, w + 2 * p
    dev = plane.device
    # Edge padding by p, then each (dr, ds) shift of the padded plane with
    # edge clamping: one clamped gather of the source plane per shift.
    rows = torch.arange(hp, device=dev) - p
    cols = torch.arange(wp, device=dev) - p
    shifts = []
    for dr, ds in zip(gp.droffs.tolist(), gp.dsoffs.tolist()):
        r = (rows + dr).clamp(0, h - 1)
        c = (cols + ds).clamp(0, w - 1)
        shifts.append(plane[r[:, None], c[None, :]])
    stack = torch.stack(shifts, dim=-1)  # [hp, wp, K]
    tab = upload(torch.from_numpy(gp.table.reshape(gp.sy * gp.sx, -1)), dev)  # [SY*SX, K]
    q = torch.einsum("hwk,ck->hwc", stack, tab)  # [hp, wp, SY*SX]
    q = q.reshape(hp, wp, gp.sy, gp.sx)
    return q.permute(0, 2, 1, 3).reshape(hp * gp.sy, wp * gp.sx)


def subcell_coords(u, v, gp: GroupPlan, w: int, h: int):
    """Normalized warped base coords (u, v) [HO, WO] f32 tensors →
    normalized NEAREST-sampling coords into Qfine."""
    z_x = u * float(np.float32(w))
    z_y = v * float(np.float32(h))
    qh, qw = gp.q_shape(h, w)

    def idx(z, ts, s, n_base, pad, total):
        zf = torch.floor(z)
        phi = z - zf
        cell = torch.zeros(z.shape, dtype=torch.int32, device=z.device)
        for t in ts.tolist():
            cell = cell + (phi >= float(np.float32(t))).to(torch.int32)
        # Non-finite coords floor to INT_MIN (GL cvtps2dq); clamping the
        # texel index to the padded range BEFORE the subcell multiply
        # keeps the exact all-taps-at-edge subcells for every
        # out-of-range z.
        zi = ifloor32(z).clamp(-pad, n_base + pad)
        sidx = s * (zi + pad) + cell
        return sidx.clamp(0, total - 1)

    sx = idx(z_x, gp.tx, gp.sx, w, gp.pad, qw)
    sy = idx(z_y, gp.ty, gp.sy, h, gp.pad, qh)
    u2 = (sx.to(torch.float32) + 0.5) * float(np.float32(1.0 / qw))
    v2 = (sy.to(torch.float32) + 0.5) * float(np.float32(1.0 / qh))
    return u2, v2


def group_samples(tex, u, v, groups):
    """Per group, the inputs of its one warped NEAREST sample:
    (channel, Qfine [Hq, Wq, 1] f32, u2, v2 [HO, WO] f32)."""
    h, w = tex.shape[0], tex.shape[1]
    for g in groups:
        gp = plan_group(g, w, h)
        q = preconv_texture(tex[..., gp.channel].to(torch.float32), gp)
        u2, v2 = subcell_coords(u, v, gp, w, h)
        yield gp.channel, q[..., None], u2, v2


def blur_preconv(tex, u, v, groups):
    """tex [H, W, C>=3] f32 (pre-transformed values), u/v [HO, WO]
    normalized base warp → {channel: [HO, WO] f32}, the contract of
    blur5x5_groups. One Qfine build + one warped NEAREST sample per
    group, through ``warp_sample`` (the CUDA kernel for a CUDA tensor)."""
    from retrocapture_tpu_torch.ops.cuda.warp_sample import warp_sample

    out: dict = {}
    for ch, q, u2, v2 in group_samples(tex, u, v, groups):
        plane = warp_sample(q, u2, v2, filter_linear=False, wrap_mode="clamp_to_edge")[..., 0]
        out[ch] = plane if ch not in out else out[ch] + plane
    return out


def _padded_hw(h: int, w: int) -> tuple[int, int]:
    return ((h + _KB - 1) // _KB) * _KB, ((w + _XB - 1) // _XB) * _XB


def blur_preconv_fits(tex_shape, groups, *, vmem_bytes: int = 24 * 2**20) -> bool:
    """Static feasibility: each group's Qfine must fit the warp
    sampler's VMEM residency (padded to its band grid)."""
    h, w = tex_shape[0], tex_shape[1]

    for g in groups:
        gp = plan_group(g, w, h)
        qh, qw = gp.q_shape(h, w)
        hp, wp = _padded_hw(qh, qw)
        if hp * wp * 4 > vmem_bytes:
            return False
    return True
