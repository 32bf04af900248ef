"""Time kernels C1 and F1 (the fullview tick's masked categorical draw and
change application) of this checkout against another checkout's, in
alternating pairs on the card.

    python3 fullview_compare.py OTHER_CHECKOUT [--pairs 12]

imports the other checkout's ``ringpop_tpu_torch`` beside this one's, so
that each side launches through its own wrappers a library built from its
own sources; records one tick's C1 and F1 calls of this checkout's engine
at ``chip_smoke.py``'s two states (N = 1000 at detection, 35 ticks; N =
4096 after 16 ticks); checks every call of both sides bit-equal to this
checkout's plain version; then times each call's kernel alone on each side
(``torch.profiler``, ``REPS`` runs, each after a flush that leaves the L2
cache clean), ``--pairs`` times: the other side first in even pairs, this
one first in odd ones.  Prints one JSON line with the card's name and power
limit, each call's per-pair µs on each side with their medians and spreads,
the median of this side's less the other's, each side's registers a thread
and the SASS opcodes of this side's C1 and F1.  Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs
from ringpop_tpu_torch.ops import fullview_kernel, threefry_kernel
from ringpop_tpu_torch.sim import fullview, threefry

PACKAGE = "ringpop_tpu_torch"
REPS = 10
KERNELS = {"C1": "threefry_categorical_kernel", "F1": "fullview_apply_kernel"}


def _package_modules() -> dict:
    return {k: m for k, m in sys.modules.items() if k == PACKAGE or k.startswith(PACKAGE + ".")}


def other_kernels(root: Path):
    """The other checkout's ``ops.threefry_kernel`` and
    ``ops.fullview_kernel``: its package imported under its own name while
    this checkout's modules are set aside, and set aside itself after, so
    each side's wrappers keep their own sources, builds and libraries."""
    root = root.resolve()
    mine = _package_modules()
    for k in mine:
        del sys.modules[k]
    sys.path.insert(0, str(root))
    try:
        tk = importlib.import_module(f"{PACKAGE}.ops.threefry_kernel")
        fk = importlib.import_module(f"{PACKAGE}.ops.fullview_kernel")
    finally:
        sys.path.remove(str(root))
        for k in _package_modules():
            del sys.modules[k]
        sys.modules.update(mine)
    for mod in (tk, fk):
        cs.check(Path(mod.__file__).resolve().is_relative_to(root), f"{mod.__name__} from {root}: {mod.__file__}")
    return tk, fk


def tick_calls(dev: torch.device) -> dict[str, tuple]:
    """One tick's C1 and F1 calls (``chip_smoke.record_one_tick``) from the
    loss1k state at detection and from the N = 4096 state after 16 ticks,
    by name."""
    out = {}
    for n, count, ticks in ((cs.FV_LOSS_N, cs.FV_LOSS_VICTIMS, cs.PIN_FV_LOSS_TICKS),
                            (cs.FV_BIG_N, cs.FV_BIG_VICTIMS, cs.FV_BIG_TICKS)):
        _, faults = cs.fullview_faults(dev, n, cs.fullview_victims(n, count), cs.FV_LOSS_DROP)
        sim = fullview.FullViewSim(n=n, seed=0, device=dev, suspect_ticks=cs.FV_SUSPECT_TICKS)
        sim.run(ticks, faults)
        calls = cs.record_one_tick(sim.params, sim.state, faults)
        for c in (c for c in calls if c[0] == "categorical"):
            out[f"C1 {'peers' if c[3] else 'targets'} {n}"] = c
        for leg, c in zip(cs.LEGS, (c for c in calls if c[0] == "apply")):
            out[f"F1 {leg} {n}"] = c
    return out


def launcher(call: tuple, tk, fk, buf: torch.Tensor):
    """(run, flush) of one recorded call through the wrappers ``tk`` and
    ``fk``, the run first checked bit-equal to the plain version; F1's
    flush also restores the planes it writes in place."""
    if call[0] == "categorical":
        _, key, mask, reps = call
        run = lambda: tk.categorical_cuda(key, mask, reps)  # noqa: E731
        cs.check(torch.equal(run(), threefry.categorical_masked_plain(key, mask, reps)), f"{tk.__file__}: C1 == plain")
        return run, lambda: buf.sum(dtype=torch.int64)
    _, planes, cand, tick, now, timeouts = call
    work = [p.clone() for p in planes]
    after = [p.clone() for p in planes]
    fullview_kernel.apply_plain(after, cand, tick, now, timeouts)

    def restore_and_flush():
        for w, p in zip(work, planes):
            w.copy_(p)
        return buf.sum(dtype=torch.int64)

    run = lambda: fk.apply_cuda(work, cand, tick, now, timeouts)  # noqa: E731
    restore_and_flush()
    run()
    cs.check(all(torch.equal(w, a) for w, a in zip(work, after)), f"{fk.__file__}: F1 == plain")
    return run, restore_and_flush


def registers(tk, fk) -> dict[str, int]:
    """Registers a thread of C1 and F1 in the libraries of ``tk`` and ``fk``."""
    out = {}
    for lib in (tk.build(), fk.build()):
        if lib.with_suffix(".log").exists():
            out.update(cs.ptxas_registers(lib, lambda s: next((k for k, v in KERNELS.items() if v in s), None)))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other", type=Path, help="the root of the checkout to compare with")
    parser.add_argument("--pairs", type=int, default=12)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("fullview_compare: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    sides = {"other": other_kernels(args.other), "this": (threefry_kernel, fullview_kernel)}
    with ThreadPoolExecutor(4) as ex:  # one nvcc a source, all at once
        list(ex.map(lambda build: build(), [m.build for mods in sides.values() for m in mods]))
    dev = torch.device("cuda")
    cs.profiler_warmup()
    buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    calls = tick_calls(dev)
    runs = {side: {name: launcher(call, *mods, buf) for name, call in calls.items()} for side, mods in sides.items()}
    us = {name: {side: [] for side in sides} for name in calls}
    for pair in range(args.pairs):
        for name in calls:
            for side in (("other", "this") if pair % 2 == 0 else ("this", "other")):
                run, flush = runs[side][name]
                found = cs.profile_ms(run, REPS, flush, "reduce_kernel")
                us[name][side].append(cs.one_kernel_ms(found, KERNELS[name[:2]]) * 1e3)
    result = {}
    for name, by_side in us.items():
        rec = result[name] = {f"{side}_us": t for side, t in by_side.items()}
        for side, t in by_side.items():
            rec[f"{side}_median_us"] = statistics.median(t)
            rec[f"{side}_spread_us"] = [min(t), max(t)]
        diffs = [a - b for a, b in zip(by_side["this"], by_side["other"])]
        rec["this_less_other_median_us"] = statistics.median(diffs)
        rec["pairs_this_slower"] = sum(d > 0 for d in diffs)
        cs.log(f"compare: {name}: other {rec['other_median_us']:.3f} us {rec['other_spread_us']}, this "
               f"{rec['this_median_us']:.3f} us {rec['this_spread_us']}; this less other "
               f"{rec['this_less_other_median_us']:+.3f} us, slower in {rec['pairs_this_slower']} of {args.pairs}")
    mine = {"C1": threefry_kernel.build(), "F1": fullview_kernel.build()}
    sass = {k: next(iter(cs.sass_opcodes(lib, lambda s, k=k: k if KERNELS[k] in s else None).values()))
            for k, lib in mine.items()}
    print(json.dumps({"card": card, "other": str(args.other), "pairs": args.pairs, "reps": REPS, "calls": result,
                      "registers": {side: registers(*mods) for side, mods in sides.items()}, "sass": sass}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
