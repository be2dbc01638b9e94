"""The paper's XR perception workloads: UL-VIO, eye gaze, classification
(the counterpart of ``repro.models.perception``).

  * VIO (UL-VIO-like): visual-feature branch + IMU branch + fusion MLP ->
    6-DoF relative pose; metrics translation/rotation RMSE (Fig. 6).
  * Eye gaze: MLP regressor -> 2-D gaze, MSE (Fig. 7).
  * Classifier (EfficientNet stand-in): small convnet -> 10 classes
    (Fig. 5/8).

Parameter trees keep the reference's layouts -- dense weights (in, out),
convolution weights HWIO, images NHWC -- so the policy's per-channel and
K-group scales (taken over the last two axes) are the same; the forward
permutes to PyTorch's layouts inside.  Two points of the reference's
arithmetic are kept on purpose: ``jax.nn.gelu`` is the tanh
approximation, and "SAME" padding at stride 2 puts the odd extra row and
column at the high end (``_same_pad``).  Convolutions and matrix
products run in full float32 (no TF32 on the card).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ref import no_tf32
from . import layers as L

__all__ = [
    "vio_init", "vio_apply", "vio_loss", "gaze_init", "gaze_apply",
    "classifier_init", "classifier_apply", "classifier_loss",
]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _mlp_init(gen: torch.Generator, dims, bias: bool = True):
    return {f"fc{i}": L.dense_init(gen, dims[i], dims[i + 1], bias=bias)
            for i in range(len(dims) - 1)}


def _mlp(p, x, act=_gelu):
    n = len(p)
    with no_tf32():
        for i in range(n):
            x = L.dense(p[f"fc{i}"], x)
            if i < n - 1:
                x = act(x)
    return x


# ---------------------------------------------------------------------------
# UL-VIO
# ---------------------------------------------------------------------------

def vio_init(gen: torch.Generator, feat_dim: int = 256, imu_rate: int = 10,
             width: int = 128):
    return {
        "visual_enc": _mlp_init(gen, (feat_dim, width, width)),
        "imu_enc": _mlp_init(gen, (imu_rate * 6, width, width)),
        "fusion": _mlp_init(gen, (2 * width, width, 6)),
    }


def vio_apply(p, batch: Dict) -> torch.Tensor:
    v = _mlp(p["visual_enc"], batch["visual"])
    i = _mlp(p["imu_enc"], batch["imu"].reshape(batch["imu"].shape[0], -1))
    return _mlp(p["fusion"], torch.cat([v, i], -1))


def vio_loss(p, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    pred = vio_apply(p, batch)
    err = pred - batch["pose"]
    t_rmse = torch.sqrt(torch.mean(torch.sum(torch.square(err[:, :3]), -1)))
    r_rmse = torch.sqrt(torch.mean(torch.sum(torch.square(err[:, 3:]), -1)))
    loss = torch.mean(torch.square(err))
    return loss, {"t_rmse": t_rmse, "r_rmse": r_rmse}


# ---------------------------------------------------------------------------
# Eye gaze
# ---------------------------------------------------------------------------

def gaze_init(gen: torch.Generator, feat_dim: int = 128, width: int = 128):
    return {"mlp": _mlp_init(gen, (feat_dim, width, width, 2))}


def gaze_apply(p, feats: torch.Tensor) -> torch.Tensor:
    return _mlp(p["mlp"], feats)


# ---------------------------------------------------------------------------
# Object classification (EfficientNet-lite stand-in convnet)
# ---------------------------------------------------------------------------

def _conv_init(gen: torch.Generator, k: int, cin: int, cout: int):
    scale = 1.0 / (k * k * cin) ** 0.5
    w = torch.rand((k, k, cin, cout), generator=gen, device=gen.device)
    return {"w": w * (2.0 * scale) - scale,
            "bias": torch.zeros((cout,), device=gen.device)}


def _same_pad(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis: (low, high), the odd
    extra element at the high end."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(p, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x (B, H, W, Cin) NHWC, w (k, k, Cin, Cout) HWIO -> NHWC."""
    w = p["w"]
    k = w.shape[0]
    ph, pw = _same_pad(x.shape[1], k, stride), _same_pad(x.shape[2], k,
                                                          stride)
    xc = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    with no_tf32():
        y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1) + p["bias"]


def classifier_init(gen: torch.Generator, n_classes: int = 10,
                    width: int = 32):
    return {
        "conv0": _conv_init(gen, 3, 3, width),
        "conv1": _conv_init(gen, 3, width, width * 2),
        "conv2": _conv_init(gen, 3, width * 2, width * 4),
        "head": L.dense_init(gen, width * 4, n_classes, bias=True),
    }


def classifier_apply(p, images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, 3) -> logits (B, n_classes)."""
    x = torch.relu(_conv(p["conv0"], images, 2))
    x = torch.relu(_conv(p["conv1"], x, 2))
    x = torch.relu(_conv(p["conv2"], x, 2))
    x = torch.mean(x, dim=(1, 2))
    with no_tf32():
        return L.dense(p["head"], x)


def classifier_loss(p, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits = classifier_apply(p, batch["images"])
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits, -1)
    ce = -torch.mean(torch.take_along_dim(logp, labels[:, None], -1))
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return ce, {"acc": acc}
