"""On-chip probe: where torch.profiler loses kernel records in one batch.

    python3 tools/diag_profiler_loss.py [--sessions 12] [--forms cold open_session]

chip_smoke.py's phase D gates each batch's CUDA launches by the kernels'
names as torch.profiler records them, and a session now and then records
fewer launches than the launch counters show.  This runs the two batches
that lost records (mask_backend="pallas" at B = 4, the default at B = 12)
for `--sessions` profiling sessions in each of these forms, in turns:

- "cold": the calls profiled from the session's first step, as
  utils/profiling.py::device_profile did before it took open_session;
- "warm": one call inside the session first, as a warm-up step whose
  records torch.profiler discards (`schedule(wait=0, warmup=1, active=1)`,
  `acc_events=True`), then the profiled call;
- "preroll": PREROLL spin kernels and a synchronisation open the session
  (their records dropped), then the profiled call;
- "sleep": the host sleeps SLEEP_S after the session opens, then the
  profiled call;
- "open_session": utils/profiling.py::open_session (profiling.PREROLL spin
  kernels, waited for; their records dropped), then the profiled call: the
  form device_profile and chip_smoke.py's cuda_events now take.

For each session it prints the records lost against the batch's known
launches (chip_smoke.batch_launches), and for a lossy session where in the
launch order the lost records sat (the positions of the reference order
that the session lacks, from the fullest session's order).  Needs a CUDA
card; builds the kernels first.
"""

import argparse
import difflib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def kernel_order(prof) -> list:
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return [e.name for e in sorted(evs, key=lambda e: e.time_range.start)]


def session(fn, form: str) -> list:
    from torch.profiler import ProfilerActivity, profile, schedule

    from sift_pyocl_tpu_torch.utils import profiling

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if form == "warm":
        with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1),
                     acc_events=True) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            fn()
            torch.cuda.synchronize()
            prof.step()
        return [n for n in kernel_order(prof) if n != "ProfilerStep*"]
    with profile(activities=acts) as prof:
        if form == "open_session":
            profiling.open_session()
        if form == "preroll":
            for _ in range(PREROLL):
                torch.cuda._sleep(20_000)
            torch.cuda.synchronize()
        if form == "sleep":
            time.sleep(SLEEP_S)
        fn()
        torch.cuda.synchronize()
    return [n for n in kernel_order(prof) if "spin_kernel" not in n]


PREROLL = 8                 # spin kernels of 20000 cycles, ~0.1 ms in all
SLEEP_S = 0.05
FORMS = ("cold", "warm", "preroll", "sleep", "open_session")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=12)
    ap.add_argument("--forms", nargs="+", choices=FORMS, default=FORMS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from sift_pyocl_tpu_torch import SiftConfig, detect_and_describe_batched
    from sift_pyocl_tpu_torch.ops import _build

    print(cs.nvidia_smi_line(), flush=True)
    _build.build()
    _build.library()
    dev = torch.device("cuda", 0)
    imgs = cs.batch_frames(cs.BATCH_SPLIT, dev)
    cases = {"pallas B=4": (SiftConfig(mask_backend="pallas"), 4,
                            {**cs.batch_launches(4), "mask_kernel": 1}),
             "default B=12": (SiftConfig(), 12, cs.batch_launches(12, 2))}
    out = {}
    for tag, (cfg, B, want) in cases.items():
        x = imgs[:B]

        def fn():
            return detect_and_describe_batched(x, cfg)

        fn()
        torch.cuda.synchronize()
        orders = {form: [] for form in args.forms}
        for _ in range(args.sessions):          # the forms in turns
            for form in args.forms:
                orders[form].append(session(fn, form))
        ref = max((o for v in orders.values() for o in v), key=len)
        for form, sessions in orders.items():
            rows = []
            for order in sessions:
                got = {k: sum(1 for n in order if k in n and "small_octaves_kernel_masks" not in n)
                       for k in want}
                lost = sum(want.values()) - sum(got.values())
                missing = []
                if len(order) < len(ref):
                    sm = difflib.SequenceMatcher(None, ref, order, autojunk=False)
                    for op, i1, i2, _, _ in sm.get_opcodes():
                        if op in ("delete", "replace"):
                            missing.append([i1, i2, ref[i1][:40]])
                rows.append({"records": len(order), "lost_gated": lost,
                             "missing_at": missing[:6]})
            out[f"{tag} {form}"] = {"reference_records": len(ref), "sessions": rows,
                                    "lossy_sessions": sum(r["lost_gated"] > 0 for r in rows),
                                    "short_sessions": sum(r["records"] < len(ref) for r in rows)}
            print(f"[profiler] {tag} {form}: {out[f'{tag} {form}']['lossy_sessions']} of "
                  f"{len(rows)} sessions lost gated records, "
                  f"{out[f'{tag} {form}']['short_sessions']} lost any; records "
                  f"{sorted(r['records'] for r in rows)} (fullest {len(ref)})", flush=True)
            for r in rows:
                if r["missing_at"]:
                    print(f"[profiler]   lost {r['lost_gated']}: at {r['missing_at']}", flush=True)
    print(json.dumps({k: [v["lossy_sessions"], v["short_sessions"]] for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
