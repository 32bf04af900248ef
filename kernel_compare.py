"""Time hand-written kernels of this checkout against another checkout's,
in alternating pairs on the card.

    python3 kernel_compare.py OTHER_CHECKOUT [--kernels C1,F1,D1] [--pairs 12]

imports the other checkout's ``ringpop_tpu_torch`` beside this one's, so
that each side launches through its own wrappers a library built from its
own sources; records the calls of the kernels asked for at
``chip_smoke.py``'s states: C1 and F1 (the fullview tick's masked
categorical draw and change application) on one tick of this checkout's
engine (N = 1000 at detection, 35 ticks; N = 4096 after 16 ticks); D1 (the
state digest) on the lifecycle headline's state after detection and
convergence (1M x 256) and on the delta engine's initial 1M x 128 state;
checks every call of both sides bit-equal to this checkout's plain
version; then times each call's kernel alone on each side
(``torch.profiler``, ``REPS`` runs, each after a flush that leaves the L2
cache clean), ``--pairs`` times: the other side first in even pairs, this
one first in odd ones.  Prints one JSON line with the card's name and power
limit, each call's per-pair µs on each side with their medians and spreads,
the median of this side's less the other's, the pairs in which this side
was slower, each side's registers a thread and the SASS opcodes of this
side's kernels.  Exits non-zero without a CUDA device.
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
from ringpop_tpu_torch.ops import fullview_kernel, telemetry_kernel, threefry_kernel
from ringpop_tpu_torch.sim import delta, fullview, telemetry, threefry

PACKAGE = "ringpop_tpu_torch"
REPS = 10
KERNELS = {"C1": "threefry_categorical_kernel", "F1": "fullview_apply_kernel", "D1": "telemetry_state_digest"}
# the wrapper module of each kernel, by its name under ops/
MODULES = {"threefry_kernel": threefry_kernel, "fullview_kernel": fullview_kernel,
           "telemetry_kernel": telemetry_kernel}
MODULE_OF = {"C1": "threefry_kernel", "F1": "fullview_kernel", "D1": "telemetry_kernel"}


def _package_modules() -> dict:
    return {k: m for k, m in sys.modules.items() if k == PACKAGE or k.startswith(PACKAGE + ".")}


def other_kernels(root: Path) -> dict:
    """The other checkout's wrapper modules (``ops.threefry_kernel``,
    ``ops.fullview_kernel``, ``ops.telemetry_kernel``), by name: its
    package imported under its own name while this checkout's modules are
    set aside, and set aside itself after, so each side's wrappers keep
    their own sources, builds and libraries."""
    root = root.resolve()
    mine = _package_modules()
    for k in mine:
        del sys.modules[k]
    sys.path.insert(0, str(root))
    try:
        mods = {name: importlib.import_module(f"{PACKAGE}.ops.{name}") for name in MODULES}
    finally:
        sys.path.remove(str(root))
        for k in _package_modules():
            del sys.modules[k]
        sys.modules.update(mine)
    for mod in mods.values():
        cs.check(Path(mod.__file__).resolve().is_relative_to(root), f"{mod.__name__} from {root}: {mod.__file__}")
    return mods


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


def digest_calls(dev: torch.device) -> dict[str, tuple]:
    """D1's calls: the lifecycle headline's state after detection and
    convergence (``chip_smoke.tel_headline_run`` without a journal) and the
    delta engine's initial 1M x 128 state, as phase 14 times them."""
    _, sim = cs.tel_headline_run(dev)
    dstate = delta.init_state(delta.DeltaParams(n=cs.DELTA_N, k=cs.DELTA_K, rng="counter"), seed=cs.DELTA_SEED,
                              device=dev)
    return {f"D1 headline {cs.LIFE_N} x {cs.LIFE_K}": ("digest", list(sim.state)),
            f"D1 delta {cs.DELTA_N} x {cs.DELTA_K}": ("digest", list(dstate))}


def launcher(call: tuple, mods: dict, buf: torch.Tensor):
    """(run, flush) of one recorded call through the wrapper modules
    ``mods``, the run first checked bit-equal to the plain version; F1's
    flush also restores the planes it writes in place."""
    clean = lambda: buf.sum(dtype=torch.int64)  # noqa: E731
    if call[0] == "digest":
        leaves = call[1]
        run = lambda: mods["telemetry_kernel"].state_digest_cuda(leaves)  # noqa: E731
        cs.check(torch.equal(run(), telemetry.tree_digest_plain(leaves)), f"{mods['telemetry_kernel'].__file__}: "
                                                                          "D1 == plain")
        return run, clean
    if call[0] == "categorical":
        _, key, mask, reps = call
        tk = mods["threefry_kernel"]
        run = lambda: tk.categorical_cuda(key, mask, reps)  # noqa: E731
        cs.check(torch.equal(run(), threefry.categorical_masked_plain(key, mask, reps)), f"{tk.__file__}: C1 == plain")
        return run, clean
    _, planes, cand, tick, now, timeouts = call
    fk = mods["fullview_kernel"]
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


def registers(mods: dict, kernels: list) -> dict[str, int]:
    """Registers a thread of ``kernels`` in the libraries of ``mods``."""
    out = {}
    for name in sorted({MODULE_OF[k] for k in kernels}):
        lib = mods[name].build()
        if lib.with_suffix(".log").exists():
            out.update(cs.ptxas_registers(lib, lambda s: next((k for k in kernels if KERNELS[k] in s), None)))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other", type=Path, help="the root of the checkout to compare with")
    parser.add_argument("--kernels", default=",".join(KERNELS), help=f"a comma-separated subset of {list(KERNELS)}")
    parser.add_argument("--pairs", type=int, default=12)
    args = parser.parse_args()
    kernels = args.kernels.split(",")
    if not kernels or any(k not in KERNELS for k in kernels):
        parser.error(f"--kernels takes a comma-separated subset of {list(KERNELS)}, got {args.kernels!r}")
    if not torch.cuda.is_available():
        print("kernel_compare: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    sides = {"other": other_kernels(args.other), "this": dict(MODULES)}
    builds = [mods[name].build for mods in sides.values() for name in sorted({MODULE_OF[k] for k in kernels})]
    with ThreadPoolExecutor(len(builds)) as ex:  # one nvcc a source, all at once
        list(ex.map(lambda build: build(), builds))
    dev = torch.device("cuda")
    cs.profiler_warmup()
    buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    calls = {}
    if "C1" in kernels or "F1" in kernels:
        calls.update({name: c for name, c in tick_calls(dev).items() if name[:2] in kernels})
    if "D1" in kernels:
        calls.update(digest_calls(dev))
    runs = {side: {name: launcher(call, mods, buf) for name, call in calls.items()} for side, mods in sides.items()}
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
    sass = {k: next(iter(cs.sass_opcodes(MODULES[MODULE_OF[k]].build(),
                                         lambda s, k=k: k if KERNELS[k] in s else None).values()))
            for k in kernels}
    print(json.dumps({"card": card, "other": str(args.other), "kernels": kernels, "pairs": args.pairs, "reps": REPS,
                      "calls": result, "registers": {side: registers(mods, kernels) for side, mods in sides.items()},
                      "sass": sass}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
