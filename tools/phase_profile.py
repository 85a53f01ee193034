"""Where a smoke phase's wall time goes on the host: the phase runs as
`tools/smoke_phases.py` runs it (`kvq` over slice_int8's model), while a
thread samples the main thread's Python stack every 5 ms; the seconds of
each function (cumulative: the samples with it on the stack; self: with it
on top) go to <out>/prof_<phase>.json, the largest first (`--out`, by
default build/profiles).

    python3 tools/phase_profile.py [--out DIR] kvq moe cli entry

A host-bound phase spends its time in Python and in the launches it makes;
the sampler costs one stack walk every 5 ms.
"""

import argparse
import collections
import json
import os
import sys
import threading
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402



class Sampler:
    """Counts, every `period` seconds, each function on thread `ident`'s stack."""

    def __init__(self, ident: int, period: float = 0.005):
        self.ident, self.period = ident, period
        self.cum, self.top = collections.Counter(), collections.Counter()
        self.samples = 0
        self.stop = False
        self.thread = threading.Thread(target=self.run, daemon=True)

    def run(self):
        while not self.stop:
            frame = sys._current_frames().get(self.ident)
            seen, first = set(), True
            while frame is not None:
                code = frame.f_code
                key = f"{os.path.basename(code.co_filename)}:{code.co_name}:{code.co_firstlineno}"
                if first:
                    self.top[key] += 1
                    first = False
                if key not in seen:
                    self.cum[key] += 1
                    seen.add(key)
                frame = frame.f_back
            self.samples += 1
            time.sleep(self.period)


def profiled(name: str, fn, out: str) -> None:
    sampler = Sampler(threading.get_ident())
    sampler.thread.start()
    t0 = time.perf_counter()
    try:
        fn()
    finally:
        sampler.stop = True
        sampler.thread.join()
        seconds = time.perf_counter() - t0
        per = seconds / max(sampler.samples, 1)
        with open(os.path.join(out, f"prof_{name}.json"), "w") as f:
            json.dump(dict(seconds=seconds, samples=sampler.samples,
                           cumulative=[(k, round(v * per, 2)) for k, v in sampler.cum.most_common(150)],
                           self=[(k, round(v * per, 2)) for k, v in sampler.top.most_common(60)]), f, indent=0)
        print(json.dumps(dict(phase=name, seconds=seconds)), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profiles"))
    ap.add_argument("phases", nargs="+")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    cs.phase_device()
    dev = torch.device("cuda", 0)
    cs.phase_build()
    for name in args.phases:
        if name == "kvq":
            _, model8 = cs.phase_slice_quant(dev, "int8", keep=True)
            profiled("kvq", lambda: cs.phase_slice_kvq(dev, model8), args.out)
            del model8
            torch.cuda.empty_cache()
        else:
            profiled(name, lambda: getattr(cs, f"phase_slice_{name}")(dev), args.out)


if __name__ == "__main__":
    main()
