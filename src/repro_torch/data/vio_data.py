"""Synthetic KITTI-like VIO sequences (a copy of ``repro.data.vio_data``,
numpy only).

Smooth SE(3) motion, 6-DoF IMU samples (accel + gyro, with bias and
noise) and "visual features" that are a fixed random projection of the
true frame-to-frame motion plus clutter, so a VIO network can recover
pose from them.  Targets are relative pose: translation (3,) and an
axis-angle rotation increment (3,), matching UL-VIO's t-RMSE / r-RMSE.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import numpy as np

__all__ = ["VIOStream", "vio_batch"]


def _traj(rng, steps: int):
    """Smooth random trajectory: per-step (dt_xyz, drot_axis_angle)."""
    acc = rng.standard_normal((steps, 3)) * 0.05
    vel = np.cumsum(acc, 0) * 0.1 + np.array([1.0, 0.0, 0.0]) * 0.3
    dpos = vel * 0.1
    dang = np.cumsum(rng.standard_normal((steps, 3)) * 0.01, 0) * 0.05
    return dpos.astype(np.float32), dang.astype(np.float32)


@dataclasses.dataclass
class VIOStream:
    batch: int = 16
    feat_dim: int = 256     # stub of the image-pair encoder output
    imu_rate: int = 10      # imu samples per frame interval
    seed: int = 0
    step: int = 0

    def state_dict(self):
        return {"seed": self.seed, "step": self.step}

    def next_batch(self) -> Dict[str, np.ndarray]:
        out = vio_batch(self.batch, self.feat_dim, self.imu_rate,
                        np.random.default_rng(
                            np.random.SeedSequence([self.seed, self.step])))
        self.step += 1
        return out


@functools.lru_cache(maxsize=None)
def _proj(rng_seed: int, feat_dim: int) -> np.ndarray:
    """The fixed (6, feat_dim) projection of pose onto features (read
    only: every caller shares it)."""
    return np.random.default_rng(rng_seed).standard_normal(
        (6, feat_dim)).astype(np.float32)


def vio_batch(batch: int, feat_dim: int, imu_rate: int, rng):
    dpos, dang = _traj(rng, batch)
    pose = np.concatenate([dpos, dang], -1)               # (B, 6)
    proj = _proj(1234, feat_dim)
    vis = pose @ proj + rng.standard_normal(
        (batch, feat_dim)).astype(np.float32) * 0.1       # visual features
    imu = np.repeat(pose[:, None, :], imu_rate, 1)
    imu = imu + rng.standard_normal(imu.shape).astype(np.float32) * 0.05
    imu[..., :3] += 0.02                                  # accel bias
    return {
        "visual": vis.astype(np.float32),                 # (B, F)
        "imu": imu.astype(np.float32),                    # (B, R, 6)
        "pose": pose.astype(np.float32),                  # (B, 6) target
    }
