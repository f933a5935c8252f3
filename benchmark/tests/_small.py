"""Cells cut to a size a CPU test run holds: a 128 x 192 frame, 128
candidate slots in octave 0, a 4-camera VO window, few scenes."""

import time

import torch

from benchmark.harness import manifest, runner

SHAPE = (128, 192)
SEED = 2 ** 33 + 17


def small_cell(name: str) -> manifest.Cell:
    cell = manifest.Cell(manifest.load_manifest(), name)
    cell.config["sift"]["kp_per_octave_cap"] = 128
    cell.traffic.update(n_blobs=60, warm_units=2, check_units=2, batch=2, pool=4, batches=2)
    if "vo" in cell.config:
        # the window's cameras all moved before the first sampled step
        cell.config["vo"].update(window=4, pts_per_frame=64, obs_per_frame=128, pnp_n=128)
        cell.traffic.update(warm_units=5)
    return cell


def run_small(name: str, seconds: float = 1.0, seed: int = SEED, after=None) -> dict:
    return runner.run(small_cell(name), seed, seconds, False, torch.device("cpu"),
                      time.perf_counter(), shape=SHAPE, after=after)
