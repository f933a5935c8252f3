"""Faults planted in a VO step's output state, where it is produced: what
the check has to refuse.  Each takes the step's state before and after,
the window length and the focal length in px, and returns the altered
state after.  The calibration reads them on the card (``calibrate.py``,
on its control seeds); the tests plant them under the port's
``vo_step`` on the CPU."""

from __future__ import annotations

import math

import torch

FAULT_PX = 5.0


def _turn_y(angle: float, like: torch.Tensor) -> torch.Tensor:
    c, s = math.cos(angle), math.sin(angle)
    return torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], dtype=like.dtype,
                        device=like.device)


def not_rolled(before, after, W: int, fx: float):
    """The window's poses and points left as they were (no roll, no BA)."""
    return after._replace(Rs=before.Rs.clone(), ts=before.ts.clone(), X=before.X.clone())


def pose_turned(before, after, W: int, fx: float):
    """The newest pose turned after the BA, by FAULT_PX px at the image
    centre."""
    Rs = after.Rs.clone()
    Rs[W - 1] = _turn_y(math.atan(FAULT_PX / fx), Rs) @ Rs[W - 1]
    return after._replace(Rs=Rs)


def points_moved(before, after, W: int, fx: float):
    """Every map point moved sideways after the BA, by FAULT_PX px in the
    newest camera."""
    R, t = after.Rs[W - 1], after.ts[W - 1]
    depth = (after.X @ R.T + t)[..., 2:]
    return after._replace(X=after.X + depth.abs() * R[0] * (FAULT_PX / fx))


VO_FAULTS = {"not_rolled": not_rolled, "pose_turned": pose_turned,
             "points_moved": points_moved}
