"""Fig. 5/6/7/8 analogues -- application accuracy vs precision (the
counterpart of ``benchmarks/bench_accuracy.py``, same rows and derived
fields).

Trains the paper's three XR perception workloads (object
classification, UL-VIO, eye gaze) briefly, then evaluates each under the
precision sweep FP32 / Posit16 / Posit8 / FP8 / FP4 / Posit4 and the two
mixtures: the paper's (``mxp_paper``) and the eq. 1-2 layer-adaptive one
(``mxp_adaptive``), all post-training (``quantize_tree``).  Then the
group-size axis: the weight-grid error of the packed plane on the
trained VIO weights.  Data come from the reference's numpy generators;
initial weights from torch generators, so the rows are the port's own
numbers, not the reference's.  It runs on the card unless ``device``
says otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core.formats import format_by_name
from ..core.policy import PrecisionPolicy, flatten_with_paths
from ..core.qat import quantize_tree
from ..core.sensitivity import assign_layer_adaptive
from ..data.vio_data import VIOStream
from ..kernels import ops
from ..models import perception as P
from ..optim import OptConfig, adamw_init, adamw_update
from .common import emit

SWEEP = ["fp32", "posit16_1", "posit8_0", "fp8_e4m3", "fp4", "posit4_1"]
STEPS = {"classify": 200, "vio": 300, "gaze": 200}


def _policy(name, params=None, grads=None):
    if name == "mxp_adaptive":
        return assign_layer_adaptive(params, grads, target_avg_bits=6.0)
    if name == "mxp_paper":
        return PrecisionPolicy.paper_mixed()
    return PrecisionPolicy.uniform(name)


def _grads(loss_fn, params, batch):
    """d loss / d params at ``params`` (a tree of the same structure)."""
    leaves = {p: t.detach().requires_grad_(True)
              for p, t in flatten_with_paths(params)}
    tree = _rebuild(params, leaves)
    loss, metrics = loss_fn(tree, batch)
    got = torch.autograd.grad(loss, list(leaves.values()))
    return _rebuild(params, dict(zip(leaves, got))), loss.detach(), metrics


def _rebuild(tree, leaves, path=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    return leaves[path]


def train(loss_fn, params, batches, lr=1e-3, steps=250):
    """``steps`` AdamW steps (weight decay 0) over ``batches(i)``; returns
    (params, the last step's metrics, the losses)."""
    ocfg = OptConfig(weight_decay=0.0)
    ost = adamw_init(params, ocfg)
    losses, m = [], {}
    for i in range(steps):
        g, loss, m = _grads(loss_fn, params, batches(i))
        params, ost = adamw_update(params, g, ost, lr, ocfg)
        losses.append(loss)
    return params, m, losses


def classify_batch(templates, i, n=64, device="cpu"):
    r = np.random.default_rng(i)
    y = r.integers(0, 10, n)
    x = templates[y] + r.normal(size=(n, 16, 16, 3)) * 1.4
    return {"images": torch.as_tensor(x, dtype=torch.float32, device=device),
            "labels": torch.as_tensor(y, device=device)}


def gaze_batch(wtrue, i, n=64, device="cpu"):
    r = np.random.default_rng(1000 + i)
    f = r.normal(size=(n, 128)).astype(np.float32)
    y = f @ wtrue + r.normal(size=(n, 2)).astype(np.float32) * 0.05
    return (torch.as_tensor(f, device=device),
            torch.as_tensor(y, device=device))


def gaze_loss(p, b):
    f, y = b
    mse = torch.mean(torch.square(P.gaze_apply(p, f) - y))
    return mse, {"mse": mse}


def run(device=None) -> None:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    def gen(seed):
        return torch.Generator(dev).manual_seed(seed)

    # ---- Fig. 5: object classification ---------------------------------
    # harder than separable (noise ~1.4x the template energy) so the sweep
    # shows the degradation ordering
    templates = rng.normal(size=(10, 16, 16, 3)).astype(np.float32)
    cparams, _, _ = train(
        P.classifier_loss, P.classifier_init(gen(1), width=8),
        lambda i: classify_batch(templates, i, device=dev), lr=3e-3,
        steps=STEPS["classify"])
    test_b = classify_batch(templates, 10_001, 512, dev)
    cal_g = _grads(P.classifier_loss, cparams, test_b)[0]
    with torch.no_grad():
        for prec in SWEEP + ["mxp_paper", "mxp_adaptive"]:
            pol = _policy(prec, cparams, cal_g)
            _, m = P.classifier_loss(quantize_tree(cparams, pol), test_b)
            emit(f"accuracy/classify_{prec}", 0.0,
                 f"acc={float(m['acc']):.4f};"
                 f"avg_bits={pol.average_bits(cparams):.2f}")

    # ---- Fig. 6: UL-VIO --------------------------------------------------
    stream = VIOStream(batch=64)

    def vio_batch(i):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in stream.next_batch().items()}

    vparams, _, _ = train(P.vio_loss, P.vio_init(gen(2)), vio_batch,
                          lr=1e-3, steps=STEPS["vio"])
    vb = vio_batch(0)
    cal_g = _grads(P.vio_loss, vparams, vb)[0]
    base = None
    with torch.no_grad():
        for prec in SWEEP + ["mxp_paper", "mxp_adaptive"]:
            pol = _policy(prec, vparams, cal_g)
            _, m = P.vio_loss(quantize_tree(vparams, pol), vb)
            t, r = float(m["t_rmse"]), float(m["r_rmse"])
            if prec == "fp32":
                base = (t, r)
            emit(f"accuracy/vio_{prec}", 0.0,
                 f"t_rmse={t:.4f};r_rmse={r:.4f};"
                 f"dt_pp={100*(t-base[0]):.2f};dr_pp={100*(r-base[1]):.2f};"
                 f"bytes={pol.model_bytes(vparams)}")

    # ---- group-size axis: weight-grid error of the packed plane ---------
    mats = [leaf for _, leaf in flatten_with_paths(vparams)
            if leaf.dim() == 2 and leaf.shape[0] >= 64]
    for prec in ("fp4", "posit4_1"):
        spec = format_by_name(prec)
        for group in (None, 128, 64, 32):
            # summed on the device, read back once
            num = sum(torch.sum(torch.square(ops.to_dense(
                ops.pack_tensor(spec, w, group_size=group)) - w))
                for w in mats)
            den = sum(torch.sum(torch.square(w)) for w in mats)
            num, den = torch.stack([num, den]).tolist()
            rel = float(np.sqrt(num / max(den, 1e-30)))
            gtag = "chan" if group is None else f"g{group}"
            emit(f"accuracy/group_scale_{prec}_{gtag}", 0.0,
                 f"w_rel_rmse={rel:.5f};n_mats={len(mats)}")

    # ---- Fig. 7: eye gaze -----------------------------------------------
    wtrue = rng.normal(size=(128, 2)).astype(np.float32) * 0.3
    gparams, _, _ = train(gaze_loss, P.gaze_init(gen(3)),
                          lambda i: gaze_batch(wtrue, i, device=dev),
                          lr=3e-3, steps=STEPS["gaze"])
    gb = gaze_batch(wtrue, 99, 512, dev)
    with torch.no_grad():
        for prec in SWEEP:
            _, m = gaze_loss(quantize_tree(gparams, _policy(prec)), gb)
            emit(f"accuracy/gaze_{prec}", 0.0, f"mse={float(m['mse']):.5f}")
