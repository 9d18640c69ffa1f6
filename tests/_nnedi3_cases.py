"""Inputs of nnedi3's pass (``rctpu::nnedi3``) for the CPU and card tests:
the nets and the textures.

``FORMS`` are the kernel's 12 forms, one a registry name: (nns, axis,
comps). ``net`` draws a net as the benchmark's preset writer does (normal
weights of standard deviation 1/4, each neuron's 32 weights of a sum
centred, biases of 1/2) in ``ops/cuda/nnedi3.net``'s layout. ``texture``
gives RGBA f32 on the k/255 grid, the levels of the RGBA8 store that every
pass after a chain's first reads, alpha included (the pass writes 1 there);
with ``flat`` a third of its rows and a block of its columns hold one level,
so that many windows have a variance under the threshold (the kernel's
``mstd2 = 0`` branch).
"""

import numpy as np
import torch

from retrocapture_tpu_torch.ops.cuda import nnedi3 as nn

FORMS = [(nns, axis, comps) for nns in nn.NNS for axis in (0, 1) for comps in (1, 3)]


def form_id(form) -> str:
    nns, axis, comps = form
    return f"nns{nns}-pass{axis + 1}-{'rgb' if comps == 3 else 'luma'}"


def weights(nns: int, seed: int):
    """``_nnedi3_weights``' arrays: (W1, W2 [32, nns], B1, B2 [nns]) f32."""
    rng = np.random.default_rng(seed)

    def centred():
        w = rng.standard_normal((nns, 32)) * 0.25
        return (w - w.mean(axis=1, keepdims=True)).T.astype(np.float32)

    w1, w2 = centred(), centred()
    return w1, w2, (rng.standard_normal(nns) * 0.5).astype(np.float32), (rng.standard_normal(nns) * 0.5).astype(
        np.float32)


def net(nns: int, seed: int, device):
    """(wt f64 [2 nns, 32], bias f32 [2 nns]) on ``device``."""
    return tuple(torch.from_numpy(a).to(device) for a in nn.net(*weights(nns, seed)))


def texture(rng, shape, device, flat=False):
    """RGBA f32 ``shape`` ([..., h, w, 4]) of k/255 levels."""
    x = rng.integers(0, 256, shape).astype(np.float32) / np.float32(255.0)
    if flat:
        h, w = shape[-3], shape[-2]
        x[..., : max(1, h // 3), :, :] = np.float32(100.0 / 255.0)
        x[..., :, : max(1, w // 4), :] = np.float32(37.0 / 255.0)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)
