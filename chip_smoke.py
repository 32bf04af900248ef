#!/usr/bin/env python3
"""Smoke run of ringpop_tpu_torch on one CUDA card: the keyed-ownership path,
the SWIM dissemination engine, the SWIM failure-detection engine, the
threefry stream, the headline benchmark record, the exact full-view
engine with its lockstep conformance gate, the telemetry plane with the
chaos and topology fault plans, the scenario fleet, the serve tier's
collector with its transports, the SWIM engines sharded over node and
rumor ranks, and the fleet's meshes with its multi-process checkpoints.

    python3 chip_smoke.py

Drives the PyTorch port's main paths once, through the entry points a user
calls: the keyed path at the scale of the ring benchmark (``BASELINE.json``
config 5: a 4096-server ring x 256 vnodes = 1,048,576 tokens, 1,048,576
keys), the delta engine at ``bench.py``'s delta configuration
(1,000,000 nodes x 128 rumor slots) and the lifecycle engine at
``bench.py``'s headline (1,000,000 nodes x 256 rumor slots, 1000 down), and
the port's twin of ``bench.py`` (``ringpop_tpu_torch/bench.py``) at its full
scale on bench.py's own stream, threefry:

1. build the Fingerprint32 kernel (``ringpop_tpu_torch/csrc/fingerprint32.cu``)
   and hold it bit-equal against its plain PyTorch version on the card and
   the numpy farm copy on the host, over every key length 0-130 (random
   bytes, >= 0x80 included), at widths that are not a multiple of 4 and
   batch sizes that are not a multiple of 32, at key matrices whose base is
   not 16-byte aligned (storage offsets 1, 3, 5, 7, 15), B = 1 and 257,
   W = 64 and 128 (the bank-conflict widths), int64 lengths, and W = 8200,
   which takes the kernel's wide route;
2. keyed lookup: hash 1,048,576 UUID-shaped 41-byte keys on the card and
   find their owners (``keyed_owner_lookup``) — owners equal a numpy
   searchsorted over the host hashes;
3. serve ring: a ``RingStore`` at capacity 2x the tokens answers
   ``serve_lookup_fused`` and ``serve_lookup_n_fused`` (n=3) against the host
   oracles, then a 1% churn commit (40 servers out, 40 in) is re-certified at
   generation 1, and the generation-0 snapshot still answers generation 0;
4. timings (CUDA events, medians, L2 flushed before each run) of the kernel's
   wrapper, its plain version and the lookups; the kernel alone by name from
   ``torch.profiler`` at 1,048,576 keys x W = 45, 64 and 128, beside its
   byte bound; the card's name and power limit, one ``{"kernels": [...]}``
   line, and the result line as the last line;
5. build the packed-plane kernels (``ringpop_tpu_torch/csrc/packbits.cu``)
   and hold the bitwise row reduce (OR and AND) and the row popcount
   bit-equal against their plain PyTorch versions on the card, at
   N = 1, 31, 33, 4097, 1,000,000 x W = 1, 2, 3, 4, 8 (planes packed from
   K = 32W - 5 slots, so the tail bits are zero), sparse, dense and random
   planes, with no row mask, a random one, an all-false and an all-true
   one, at a base that is not 16-byte aligned and at W = 1032 (wider than
   one block's column tile); then each kernel alone
   by name from ``torch.profiler`` at the delta path's shapes, beside its
   byte bound;
6. the delta engine at 1,000,000 x 128, ``exchange="shift"``,
   ``rng="counter"``, from ``init_state(seed=1)``: the first 8 ticks on the
   kernels and, side by side, with the plain reduces on the card, every leaf
   equal at every tick; then ``run_until_converged(max_ticks=4096,
   check_every=8)`` converges in the tick count of the JAX package (pinned
   below, from a CPU run of ``ringpop_tpu``) with the sha256 of every final
   leaf equal to the pinned JAX digests; its wall time (CUDA events) and a
   ``torch.profiler`` breakdown of one 8-tick block by kernel and by phase,
   with the device's busy share of the window;
7. the uniform exchange with faults at 1,000,000 x 128: 1000 nodes down,
   ``drop_rate=0.01``, 24 ticks from ``seed=1``; the final leaves' digests
   equal the pinned JAX ones;
8. build the lifecycle kernels (``ringpop_tpu_torch/csrc/lifecycle.cu``)
   and hold the subject-slot walk (L1: checksum mode, and detect mode at
   three observer masks x SUSPECT/FAULTY) and the first-live-learner select
   (L2: no up mask, a random one, all down, each with ``want`` None, empty,
   all and random, and a plane whose lone live learner of three slots is
   the last row) bit-equal against their plain PyTorch versions on the
   card, at N = 1, 31, 33, 4097, 1,000,000 x K = 40, 64, 256, over sparse,
   medium and dense planes with empty rows and slot columns and rumor
   tables where every subject holds one slot, where subjects hold the two
   or three slots around each word boundary, where one subject holds a
   third of the slots, with free slots, with none and with only free
   slots; and both kernels at the widest plane they take
   (``lifecycle_kernel.MAX_WORDS`` = 219 words, K = 7008), whose shared
   memory fits a block while L2's at one word more does not, and a refusal
   one word past it;
9. the lifecycle engine at 1,000,000 x 256, ``rng="counter"``, shift, from
   ``seed=0`` with bench.py's 1000 victims down: the first 8 ticks on the
   kernels and, side by side, on the plain versions (walk, first learner
   and row reduces), every leaf and both queries equal at every tick and
   the tick-8 digests equal to the JAX pins; L1 and L2 alone by profiler
   name on that tick-8 state (its slots in flight) beside their bounds, and
   the detection check and the checksums with the kernel and with the plain
   walk; then the main path
   ``LifecycleSim(...).run_until_detected(max_ticks=4096, check_every=32,
   blocks_per_dispatch=8)``, ``run_until_converged(...)`` and
   ``view_checksums`` reach the JAX package's tick counts, final-leaf
   digests and checksums (pinned below), with their launch counts
   and wall times (CUDA events, three runs); then the same 128 ticks
   again in four 32-tick blocks under ``torch.profiler`` (by phase and by
   kernel, the device's busy share, launches a tick in every block — no
   more than 962 — with the profiler's record of the port's launches equal
   to the wrappers' own counts, and every L2 launch's device time, split by
   whether a timer fired, beside its data-dependent bound, each launch ==
   plain on its inputs), and L1 and L2 alone on the state of each
   detection check (ticks 32, 64, 96, 128) with its slots in flight and
   the subjects that hold two or more;
10. build the threefry kernel T1 (``ringpop_tpu_torch/csrc/threefry.cu``) and
   hold ``split`` (2, 3, 5 keys), ``randint``, ``uniform`` and the raw bits
   bit-equal against their plain PyTorch versions on the card: keys of
   three seeds and of chained splits, shapes (), (1,), (n,), (n, 3) at
   n = 1,000,000, spans 1, 2, 3, 1000, 1024, 65535, 65536, 65537, n - 1, n,
   2**31 - 1, 2**31, 2**32 - 1 and hi <= lo (randint's one- and two-stream
   variants, with and without the reciprocal's add indicator), every
   kernel at the ragged element counts 1-9, 4095, 4097 and 3,000,001, and
   two draws of 2**32 + 2**20 int32 values (spans 1000 and n: two streams
   and one), whose heads, elements around 2**32 and tails equal the plain
   threefry2x32 on explicit (hi, lo) counters; then T1 alone by profiler
   name at each shape the main path draws, beside its bound: the larger of
   the bytes over 3.35 TB/s and the function's own instructions (the least
   an element needs, counted from its definition, ``T1_OPS``, and held to
   no more than each kernel's SASS an element: the difference between
   builds of 8 and 4 elements a thread, over 4) over the card's
   instruction rate;
11. the headline's first 8 ticks at threefry with T1 and, side by side, with
   the plain draws on the card, every leaf equal and the tick-8 digests
   equal to the JAX pins; then the main path, ``bench.run_bench`` at full
   scale and ``rng="threefry"``: its record (printed on a line of its own)
   reaches the JAX package's detection and convergence ticks, view-checksum
   sum and digest, final leaf digests, delta ticks and delta digests (pinned
   below), with T1 launched once a draw; phase 7's uniform exchange with
   faults at threefry against its pins; a 32-tick block at each stream under
   the profiler (launches a tick, busy share); detection at both streams in
   turns (counter, threefry, threefry, counter);
12. hold the fullview kernels bit-equal against their plain versions on the
   card: C1, the masked categorical draw (``csrc/threefry.cu``), over
   random masks at densities 0.01, 0.5 and 0.99 with rows that allow
   nothing, everything and only the last entry, at N = 1, 31, 33, 1000,
   4097, 8192, reps None and 3, keys of three seeds and chained splits;
   long rows ([7, 16385], [64, 20003]); masks whose base lies 1..7 bytes
   past alignment; three draws whose counters pass 2**32, at the rows
   around the crossing on explicit counters: [1432, 3, 1,000,000] and two
   whose crossing falls inside one of C1's runs, [1432, 3, 1,000,003] and
   [143152, 3, 10,001]; T1's ``fold_in`` at d = 0, 1, 5, 2**31 - 1,
   2**32 - 1; F1, the change application
   (``csrc/fullview.cu``), on random states and candidate batches at N =
   1, 3, 31, 33, 1000, 4097 and densities 0.01, 0.5, 1.0, every plane, and
   its refusal of candidates and planes its word loads cannot take;
13. a) BASELINE's north-star gate on the card: the port's
   ``LockstepRunner(n=1000, seed=7)`` with nodes 99, 499, 999 down for 12
   ticks and 8 healed, checked every 4 and at the end, the host oracle
   against the CUDA engine, with its wall time and the engine's share;
   b) the main path, BASELINE config 2's shape on fullview: N = 1000, 10
   victims, 5 % loss, free-running on threefry until every live node
   holds every victim Faulty, checked every tick — the JAX package's tick
   count (pinned below) and final-leaf digests, with C1 twice, F1 five
   times and fold_in once a tick; c) the same recipe at N = 4096 (41
   victims, 268 MB of state), 16 ticks against the pinned digests; then
   an 8-tick block at each size under the profiler (ms and launches a
   tick, busy share, device time by ``fullview.PHASES``), and the same
   block with C1 and F1 swapped for their plain versions; C1 and F1 alone
   on the calls of one tick at each size beside their bounds;
14. a) hold the telemetry kernels (``csrc/telemetry.cu``) bit-equal against
   their plain versions on the card: D1, the state digest, over
   lifecycle-shaped leaf sets at N = 1, 31, 33, 4097, 1,000,000 x K = 40,
   64, 256 (random and all-negative int8 planes) at flat offsets 0, 5 and
   2**32 - 3, leaves 1..15 elements past alignment, both engines' states
   and an int8 plane of 2**32 + 256 elements, whose flat index wraps; P1,
   the per-tick accumulate, at N up to 1,000,000 x W = 1, 2, 8 on random,
   empty and full planes; R1, the record's float32 sums in the JAX
   package's order, bit for bit at N up to 1,000,000 and 1023 x W = 1, 2, 8
   with sums past 2**24; then each alone by profiler name at the main
   path's shapes beside its bound, and D1's SASS an element; b) the main
   path, phase 9's headline with a ``TelemetrySink`` journal and
   ``journal_views=True``: phase 9's tick counts and final digests, the
   JAX package's block records bit for bit (pinned below), P1 once a tick,
   D1 once and R1 twice a record; detection with telemetry off and on in
   turns and a 32-tick block each way under the profiler, beside the
   figures before D1's redesign;
   c) simbench's churn100k (100,000 x 256, the churn plan, 256 ticks),
   d) ``topo_scenario_plan("zone_loss")`` at 4096 x 32 with the per-tier
   counters, e) BASELINE config 4, partition1m (1,000,000 x 128 on the
   delta engine): their journals and verdicts == the JAX pins, with their
   wall times.  Phase 14's journals and the whole record go to
   ``chip_smoke_out/``;
15. the scenario fleet (``sim/montecarlo``, ``sim/scenarios``,
   ``sim/snapshot``), each replica stepped through the solo lifecycle tick:
   first a twin, 2 replicas of the scored grid at 4096 x 32 with telemetry,
   4 ticks of detection and a fetch on the kernels and on their plain
   versions (L1, L2, S1, T1, P1, D1, R1 at the fleet's shapes), every leaf
   and record equal; a) simbench's ``montecarlo`` at full scale (4096 x
   32, 32 replicas seeded 0..31, threefry, 4 victims, detection checked
   every tick): the distribution and the 32 final digests == the JAX pins,
   with a 2-tick fleet block at B = 1 and B = 32 under the profiler
   (launches and ms a fleet tick, busy share); b) simbench's ``mc_churn``
   (up to 128 background crashes, 4096 ticks at most) with its three
   2-replica contrasts: the curve, cliff and contrasts == the pins; c)
   mc_chaos's scored journal on its grid's corner (doses 0 and 128, losses
   0 and 0.1: 4 of its 128 scenarios) for 256 ticks in 16-tick blocks,
   saved at tick 128 and run on, then restored from the checkpoint and run
   again: both runs' verdicts and digests == each other and the pins; each
   with its wall time and the wrappers' launch counts;
16. the serve tier (``serve/service``, ``serve/shm``, ``net/channel``,
   ``serve/bench``): a) simbench's ``serve_ring`` at full scale through the
   port's ``run_ab`` with the store on the card (64 servers x 100 vnodes,
   4 frontend processes over the shared-memory ring, 8192-key batches x 16,
   5 measured reps, 300 B = 1 requests): serve and bisect owner digests
   equal per (worker, rep), every answer at the pinned generation, a live
   update re-certified, the B = 1 answers == the bisect oracle, and a
   journal with ``serve`` and ``ring_update`` records (the last one's gen ==
   the committed one); b) the same over TCP with the json codec at
   simbench's non-full settings; c) a ``RingService`` on its own loop over
   BASELINE config 5's ring on the card (4096 servers x 256 vnodes), fed
   1,048,576 keys as 128 requests of 8192 with an n = 3 group every 8, a 1 %
   churn commit on another thread while requests are pending: every answer
   at generation 0 or 1 == that generation's host oracles; the qps, the
   B = 1 latencies, the flush counts and one profiled flush's launches at
   8192 and 65,536 keys.  The serve path runs no hand-written kernel.
17. the SWIM engines sharded over 4 node ranks (``ringpop_tpu_torch/parallel``:
   one spawned process a rank, ``torch.distributed`` over NCCL when every
   rank has a card of its own, else over gloo with every leg staged
   through host memory, as on one card), after the same cells unsharded on
   this card: a) simbench's ``sharded100k`` (100,000 x 256, counter,
   ``suspect_ticks`` 10, 100 victims): 6 ticks, then the detect path in
   blocks of 32 ticks (at most 16), every gathered leaf, the blocks and the
   verdict == the unsharded run's; b) the headline at the counter stream
   over the ranks: the tick-8 leaves == ``PIN_LIFE_TWIN``, L1 on each rank's
   block of that state == its plain version (L1 takes a row block since
   this phase), then ``LifecycleSim`` detection and convergence in the
   pinned ticks, every final leaf == ``PIN_LIFE``, the view checksums ==
   ``PIN_LIFE_VIEWS_*``, and the digest combined from the ranks' partial
   sums (D1 at each block's global offset) == ``tree_digest`` of the
   gathered state; c) the delta engine at 1,000,000 x 128 (shift, counter)
   over the ranks converges in ``PIN_SHIFT_TICKS`` to ``PIN_SHIFT``.  Each
   cell prints its ms a tick sharded (each rank, CUDA events) against
   unsharded, the exchange's sends a leg and its bytes a tick (legs,
   collectives, staged), and S1, S2, L1, L2 and D1's launches on each rank.
18. the rumor axis: the engines on (P, R) meshes, rank p·R + r holding node
   rows block p and word block r of the packed planes (slot block r of
   ``pcount``), with telemetry under the mesh.  The unsharded chaos twins
   and churn100k on this card first.  8 ranks on simbench's own 4 x 2: a)
   ``sharded100k`` as 17a, every leaf, the blocks and the verdict == the
   unsharded run's; b) simbench's chaos twin (``_chaos_sharded_twin``:
   4096 x 64, ``suspect_ticks`` 6, 24 ticks of the churn, flap, asym and
   topology smoke plans at horizon 64): every leaf == the unsharded run's
   == ``PIN_CHAOS_TWIN``, and the digest combined on every rank == the pin;
   c) churn100k (100,000 x 256, horizon 256) with telemetry on and a
   ``TelemetrySink`` journal: its 16 block records and verdict ==
   ``PIN_TEL_CHURN``, every float exact, on every rank; then S1, S2, L1,
   L2, P1, D1 and R1 == their plain versions on every rank's block.  4
   ranks on 2 x 2: d) the headline at 1,000,000 x 256 to ``PIN_LIFE_TWIN``,
   ``PIN_LIFE_DETECT_TICKS`` and ``PIN_LIFE*``, and the delta at 1,000,000 x
   128 to ``PIN_SHIFT``.  Each rank prints its ms a tick sharded against
   unsharded, the collectives, bytes sent and bytes staged a tick on each
   axis, and its launches; every cell's kernels launched on every rank.
19. the fleet's meshes, the process-sliced sweep and its checkpoints
   (``sim/montecarlo`` on a ``("batch", "node", "rumor")`` fleet mesh,
   ``FleetSweep(global_b=)``, the multi-process store of ``sim/snapshot``),
   at the counter stream.  a) simbench's fleet twin (4096 x 64, B = 6, 24
   ticks with telemetry, then 16 ticks of ``run_until_detected``)
   unsharded on this card (== ``PIN_FLEET_TWIN``), then over a (2, 2, 2)
   fleet mesh of 8 ranks: every rank's records, detection ticks, flags and
   digests == the unsharded run's; then S1, S2, L1, L2, P1, D1 and R1 ==
   their plain versions on every rank's block of a replica with slots in
   flight.  b)
   simbench's ``fleet_scale`` sweep (4096 x 64, B = 64: ``b_doses`` 16 of
   its 512, horizon 32) at P = 1, at P = 2 (each process its slice, saved
   at tick 16 into the store, each writing only its rows) and restored
   here at P = 1: digests and scores == each other == ``PIN_FLEET_SCALE``,
   and the P = 2 ranks' device-memory peak under 0.75 of the P = 1 run's.
   c) the P = 2 checkpoint restored onto a (2, 2, 1) fleet mesh of 4 ranks
   and run on: == ``PIN_FLEET_SCALE``.  Each cell prints its walls and ms a
   fleet tick sharded and unsharded, per axis the collectives and bytes a
   tick, the store's bytes and seconds, and each rank's launches.

Every ``torch.profiler`` session opens with ``profiler_warmup``'s marks:
the profiler drops the device records of the first work a session sees,
more the longer the process has profiled, so the measured work comes after
them and a record that still misses any of it is taken again or fails.

``python3 chip_smoke.py --kernel-profile`` runs step 4's kernel profile
alone and prints it as one JSON line: run from another checkout's root it
measures that checkout's kernel, so two versions can be compared on one
card in one run of the chip machine.  ``python3 chip_smoke.py
--lifecycle-kernels`` builds the lifecycle kernels and runs step 8 alone;
``--learner-planes`` times L2 alone on synthetic 1M x 256 planes (dense,
sparse, late and empty columns) with each ``want``; ``--detect-wall
[counter|threefry]`` times the headline's ``run_until_detected`` alone at
that stream (counter unless named), five runs (run it from another
checkout's root, with this script copied there, to compare two versions
in one call); ``--threefry`` builds the kernels and runs steps 10-11
alone; ``--fullview`` builds them and runs steps 12-13 alone;
``--telemetry`` builds them and runs step 14 alone; ``--fleet`` builds them
and runs step 15 alone; ``--serve`` runs step 16 alone (no kernel build); ``--sharded`` builds
the kernels and runs steps 17 and 18 alone, ``--rumor-axis`` step 18 alone, ``--fleet-mesh`` step 19
alone.  ``kernel_compare.py``
times D1, C1 and F1 against another checkout's in alternating pairs.

Exits non-zero, printing no result, on any failed check or when no CUDA
device is available.  Imports nothing of JAX or of ``ringpop_tpu``.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ringpop_tpu_torch import bench
from ringpop_tpu_torch.hashing.farm import fingerprint32_batch, pack_strings
from ringpop_tpu_torch.ops import (
    _cuda_build,
    fullview_kernel,
    hash_kernel,
    lifecycle_kernel,
    packbits_kernel,
    telemetry_kernel,
    threefry_kernel,
)
from ringpop_tpu_torch.ops.hash_ops import fingerprint32_device, keyed_owner_lookup, upload_keys
from ringpop_tpu_torch.ops.ring_ops import build_ring_tokens, host_lookup_n, ring_lookup
from ringpop_tpu_torch.serve.state import RingStore, serve_lookup_fused, serve_lookup_n_fused
from ringpop_tpu_torch.sim import (
    chaos,
    conformance,
    delta,
    fullview,
    lifecycle,
    montecarlo,
    packbits,
    prng,
    scenarios,
    telemetry,
    threefry,
    topology,
)
from ringpop_tpu_torch.swim.member import FAULTY, SUSPECT

SEED = 20261016
N_SERVERS = 4096
REPLICAS = 256
N_KEYS = 1 << 20
KEY_LEN = 41  # "trip:" + 8-4-4-4-12 hex
N_SAMPLE = 16_384  # keys checked against the host LookupN walk
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)

# the delta engine's configuration: bench.py's delta run (bench.py:414, 546)
DELTA_N, DELTA_K, DELTA_SEED = 1_000_000, 128, 1
DELTA_MAX_TICKS, DELTA_CHECK_EVERY = 4096, 8
PACKBITS_ROWS = (1, 31, 33, 4097, 1_000_000)
PACKBITS_WIDTHS = (1, 2, 3, 4, 8)
# pinned from the JAX package (ringpop_tpu.sim.delta, rng="counter") run on
# the CPU; tests/test_torch_chip_smoke_pins.py recomputes them
PIN_SHIFT_TICKS = 16
PIN_SHIFT = {
    "learned": "d1862c53f4fa3daac39b7969f32c448cd7af87ee59a42fb6dd567fc4be68d3ea",
    "pcount": "4238245cc664c2d3197e49baed50a2c5f05323f54644b110ff126943b0fe444a",
    "ride_ok": "d1862c53f4fa3daac39b7969f32c448cd7af87ee59a42fb6dd567fc4be68d3ea",
    "tick": "097328e8c957de2428283954f6a1ee8ff7ad7def12e100a600178407f5decf24",
    "key": "01acecb507abfe1a354aa8064f4af5d3f1acd019e37db3c11c97523b71c76e9d",
}
UNIFORM_TICKS, UNIFORM_DOWN, UNIFORM_DOWN_SEED, UNIFORM_DROP = 24, 1000, 0, 0.01
PIN_UNIFORM = {
    "learned": "2a2ab808e0ccb06a78a9b17715d5cf7aa750454519ce1e1a7d56cc86250f87e6",
    "pcount": "2965581ccdfe0a0ab16dc78b0f4023cfba89c207417391dbc6755fa7eec1b426",
    "ride_ok": "d1862c53f4fa3daac39b7969f32c448cd7af87ee59a42fb6dd567fc4be68d3ea",
    "tick": "17fa9c7f5e9039a2d46e73e17d8e094a796ee4c313199bad42db4ee1dc30d865",
    "key": "01acecb507abfe1a354aa8064f4af5d3f1acd019e37db3c11c97523b71c76e9d",
}
# the lifecycle engine's configuration: bench.py's headline (bench.py:419-440)
LIFE_N, LIFE_K, LIFE_SEED, LIFE_VICTIMS = 1_000_000, 256, 0, 1000
LIFE_MAX_TICKS, LIFE_CHECK_EVERY, LIFE_TWIN_TICKS, LIFE_RUNS = 4096, 32, 8, 3
LIFECYCLE_ROWS = (1, 31, 33, 4097, 1_000_000)
LIFECYCLE_SLOTS = (40, 64, 256)
# pinned from the JAX package (ringpop_tpu.sim.lifecycle, rng="counter") run
# on the CPU; tests/test_torch_chip_smoke_pins.py recomputes them
PIN_LIFE_DETECT_TICKS, PIN_LIFE_CONVERGE_TICKS = 128, 0
PIN_LIFE_TWIN = {  # after the first LIFE_TWIN_TICKS ticks
    "r_subject": "d74b088d291fa3ce5557e893dc498ea115c87d6da6a6588dfd97c32a96f87d71",
    "r_inc": "5f70bf18a086007016e948b04aed3b82103a36bea41755b6cddfaf10ace3c6ef",
    "r_status": "2661920f2409dd6c8adeb0c44972959f232b6429afa913845d0fd95e7e768234",
    "r_deadline": "a4f141dde60bd5a1235d5be9e1c3b0f02a5afc5090f28d95ffd201de19f608a7",
    "learned": "e0834c1215aa5209c8ca54236c5ccedf25275de4d378a2dbe4c89b21ff425531",
    "pcount": "17157d15d7e26c866e2a69bc08ee8f5cf7026583be9ba60890863a17b5cb7e54",
    "ride_ok": "90b1c49f30fb1e958e1dbce3cb82a0ec15a9ac18a5dda4f63a91eb41f00acbb2",
    "base_status": "d29751f2649b32ff572b5e0a9f541ea660a50f94ff0beedfb0b692b924cc8025",
    "base_inc": "8dbe5f139fd946d4cd84e8cc612cd9f68cbc87e394457884acc0c5dad56dd8dd",
    "base_present": "1fb6a051d8996888485d47fea0007a88e1e78ea273fa5fb60e1ab00608dbb764",
    "base_pending": "bfa872a3021d48c84643f831ee5f9358bceccf3ad6a5f8b3a7a00e0b3f22bdbc",
    "base_deadline": "8475ac20a4d76c1cc91be24ed0ae8df288cccf830bc15d9acb7da81cab0b5110",
    "self_inc": "8dbe5f139fd946d4cd84e8cc612cd9f68cbc87e394457884acc0c5dad56dd8dd",
    "tick": "dc765660b06ee03dd16fd7ca5b957e8c805161ac2c4af28c5a100ab2ab432ca1",
    "key": "af5570f5a1810b7af78caf4bc70a660f0df51e42baf91d4de5b2328de0e83dfc",
}
PIN_LIFE = {  # after run_until_detected and run_until_converged
    "r_subject": "5f4ecdb7b71c3e403983fe405cddcdc2f2576b655fdb3e80d94a6f7c32e58bc2",
    "r_inc": "5f70bf18a086007016e948b04aed3b82103a36bea41755b6cddfaf10ace3c6ef",
    "r_status": "f5c22e35d04167e37913e7963ce033b1f3d17a924a4e6fe5fc95af1224051921",
    "r_deadline": "6c3181e9bbc7e417cee2f110dddc2091481502f5630644f72192862c39b601d4",
    "learned": "1a100baed95a65f66d01cd08644b28e134783fd0c52ac7e35ad52a452e8b90b2",
    "pcount": "ff18e8f15bd1b40478433ebafd0b49b46c875ad9e8eabf0cf3747f493ebb6200",
    "ride_ok": "90b1c49f30fb1e958e1dbce3cb82a0ec15a9ac18a5dda4f63a91eb41f00acbb2",
    "base_status": "854b1c3e9eab4ebbb97227e0c67dcf6e1679c69e28aac64c6f4f89e5fa4e003e",
    "base_inc": "8dbe5f139fd946d4cd84e8cc612cd9f68cbc87e394457884acc0c5dad56dd8dd",
    "base_present": "1fb6a051d8996888485d47fea0007a88e1e78ea273fa5fb60e1ab00608dbb764",
    "base_pending": "3e272cb77b8338b209212d16b0e490e050c178d18cd221181cc67015cb2a6f3d",
    "base_deadline": "4942aab639a923b98047de571aa82528ab1016fc91d9aa9f905ef7599b402cf4",
    "self_inc": "8dbe5f139fd946d4cd84e8cc612cd9f68cbc87e394457884acc0c5dad56dd8dd",
    "tick": "50c8ba3a6170f0a2fb6736ece8a603576ef6309a35e810911599bc6211b554a9",
    "key": "af5570f5a1810b7af78caf4bc70a660f0df51e42baf91d4de5b2328de0e83dfc",
}
LIFE_LAUNCHES_A_TICK_MAX = 962  # the lifecycle tick's kernel launches before L2 took a want mask
SMEM_OPTIN = 232_448  # shared memory one H100 block can opt in to, where torch does not report it
WARMUP_MARKS, MARK_CYCLES, MARK_TAG = 100, 20_000, "spin_kernel"  # torch.cuda._sleep's kernel
PIN_LIFE_VIEWS_SUM = 1194085248  # view_checksums(...) summed in wrapping uint32
PIN_LIFE_VIEWS_SHA = "7779b7f65d5d326f6b04c5fba2a49e3582dd02db8bea59052fea5756eed095ce"
# phase 11: bench.py's own stream, threefry — pinned from the JAX package
# (ringpop_tpu.sim.delta and .lifecycle at their default rng) run on the CPU;
# tests/test_torch_chip_smoke_pins_threefry.py recomputes them
PIN_TF_DELTA_TICKS = 16
PIN_TF_DELTA = {  # delta 1M x 128 shift, after run_until_converged
    "learned": "d1862c53f4fa3daac39b7969f32c448cd7af87ee59a42fb6dd567fc4be68d3ea",
    "pcount": "4254f6be605f25c6c800a457eb2ed2a4d2d87976f84d00eca3081b5236ffd067",
    "ride_ok": "d1862c53f4fa3daac39b7969f32c448cd7af87ee59a42fb6dd567fc4be68d3ea",
    "tick": "097328e8c957de2428283954f6a1ee8ff7ad7def12e100a600178407f5decf24",
    "key": "f580307267d35e1dfb16b1f56a1bd2e4383695a9cfc918fe08d51a75a68d8f48",
}
PIN_TF_UNIFORM = {  # phase 7's configuration at threefry, after 24 ticks
    "learned": "2a2ab808e0ccb06a78a9b17715d5cf7aa750454519ce1e1a7d56cc86250f87e6",
    "pcount": "b4ece4ff55b69f318c80a91c11db5eac7bf5e227c425d424fd24973e16fe3720",
    "ride_ok": "d1862c53f4fa3daac39b7969f32c448cd7af87ee59a42fb6dd567fc4be68d3ea",
    "tick": "17fa9c7f5e9039a2d46e73e17d8e094a796ee4c313199bad42db4ee1dc30d865",
    "key": "737b00b329275070be41247e9f23b00169f6eebbd975d913174d63816ace603f",
}
PIN_TF_LIFE_DETECT_TICKS, PIN_TF_LIFE_CONVERGE_TICKS = 128, 0
PIN_TF_LIFE_TWIN = {  # the headline after the first LIFE_TWIN_TICKS ticks
    "r_subject": "bd6b75667d5bb0040c85d907733ca6f368bc6644d0d839e30d54e92b4f9f0fe1",
    "r_inc": "5f70bf18a086007016e948b04aed3b82103a36bea41755b6cddfaf10ace3c6ef",
    "r_status": "2661920f2409dd6c8adeb0c44972959f232b6429afa913845d0fd95e7e768234",
    "r_deadline": "a4f141dde60bd5a1235d5be9e1c3b0f02a5afc5090f28d95ffd201de19f608a7",
    "learned": "8a142967560fd9a7d7dff39014b856cdedfcb9c5fededc940ed4bc983d73a3e2",
    "pcount": "97fbaea34da8a923aba03c7b13f1b1d6ec97091cc914de8828e0edbf47b608ed",
    "ride_ok": "90b1c49f30fb1e958e1dbce3cb82a0ec15a9ac18a5dda4f63a91eb41f00acbb2",
    "base_status": "d29751f2649b32ff572b5e0a9f541ea660a50f94ff0beedfb0b692b924cc8025",
    "base_inc": "8dbe5f139fd946d4cd84e8cc612cd9f68cbc87e394457884acc0c5dad56dd8dd",
    "base_present": "1fb6a051d8996888485d47fea0007a88e1e78ea273fa5fb60e1ab00608dbb764",
    "base_pending": "bfa872a3021d48c84643f831ee5f9358bceccf3ad6a5f8b3a7a00e0b3f22bdbc",
    "base_deadline": "8475ac20a4d76c1cc91be24ed0ae8df288cccf830bc15d9acb7da81cab0b5110",
    "self_inc": "8dbe5f139fd946d4cd84e8cc612cd9f68cbc87e394457884acc0c5dad56dd8dd",
    "tick": "dc765660b06ee03dd16fd7ca5b957e8c805161ac2c4af28c5a100ab2ab432ca1",
    "key": "26ecd1a992a1f2348f77062978815821f33ddb7b16e73a65f9caad78b136e19d",
}
PIN_TF_LIFE = {  # after run_until_detected and run_until_converged
    "r_subject": "5f4ecdb7b71c3e403983fe405cddcdc2f2576b655fdb3e80d94a6f7c32e58bc2",
    "r_inc": "5f70bf18a086007016e948b04aed3b82103a36bea41755b6cddfaf10ace3c6ef",
    "r_status": "f5c22e35d04167e37913e7963ce033b1f3d17a924a4e6fe5fc95af1224051921",
    "r_deadline": "f978253cfd5ec36193e3dcf2b53b186a2c95f9ae4572bcb99b54bb2bf33fc5da",
    "learned": "1a100baed95a65f66d01cd08644b28e134783fd0c52ac7e35ad52a452e8b90b2",
    "pcount": "ff18e8f15bd1b40478433ebafd0b49b46c875ad9e8eabf0cf3747f493ebb6200",
    "ride_ok": "90b1c49f30fb1e958e1dbce3cb82a0ec15a9ac18a5dda4f63a91eb41f00acbb2",
    "base_status": "854b1c3e9eab4ebbb97227e0c67dcf6e1679c69e28aac64c6f4f89e5fa4e003e",
    "base_inc": "8dbe5f139fd946d4cd84e8cc612cd9f68cbc87e394457884acc0c5dad56dd8dd",
    "base_present": "1fb6a051d8996888485d47fea0007a88e1e78ea273fa5fb60e1ab00608dbb764",
    "base_pending": "3e272cb77b8338b209212d16b0e490e050c178d18cd221181cc67015cb2a6f3d",
    "base_deadline": "d2068647d423373d4603351d448f9f3c38bdd6d820be7fe981486584287291be",
    "self_inc": "8dbe5f139fd946d4cd84e8cc612cd9f68cbc87e394457884acc0c5dad56dd8dd",
    "tick": "50c8ba3a6170f0a2fb6736ece8a603576ef6309a35e810911599bc6211b554a9",
    "key": "f4f77a214fcbef6fa64a0ae116b4cf359295719a4821acf7add861fb14457a9d",
}
PIN_TF_LIFE_VIEWS_SUM = 1194085248  # view_checksums(...) summed in wrapping uint32
PIN_TF_LIFE_VIEWS_SHA = "7779b7f65d5d326f6b04c5fba2a49e3582dd02db8bea59052fea5756eed095ce"
# phase 10: kernel T1 at the main path's shapes, and a draw whose counters pass 2**32
TF_N = 1_000_000
TF_SEEDS = (0, 1, SEED)
TF_BIG = (1 << 32) + (1 << 20)  # int32 outputs: 17.2 GB
TF_TAILS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 4095, 4097, 3_000_001)  # T1 stores runs of 8 and writes tails element by element
# spans (lo, hi) of phase 10: 1, 2, n - 1, n, 2**31 - 1, hi <= lo, then randint's
# two-stream spans (3, 7, 1000, 65535), one-stream spans beside 2**16 (1024,
# 65536, 65537) and the reciprocal's corners 2**31 and 2**32 - 1
TF_SPANS = ((0, 1), (0, 2), (0, TF_N - 1), (1, TF_N), (0, TF_N), (0, 2**31 - 1), (7, 7), (9, 3), (0, 3), (0, 7),
            (0, 1000), (0, 1024), (0, 65535), (0, 65536), (0, 65537), (-1, 2**31 - 1), (-(2**31), 2**31 - 1))
# Hopper SM: 4 schedulers, each issuing one 32-lane warp instruction a clock
# (white paper); its INT32 pipe alone has 64 lanes, and T1's IMADs go to the
# FMA pipe, so T1 runs past the INT32 pipe's rate
DISPATCH_LANES_PER_SM = 128
T1_KERNELS = {"split": "threefry_split_kernel", "bits": "threefry_bits_kernel",
              "randint": "threefry_randint_kernel", "uniform": "threefry_uniform_kernel"}
# randint's instantiations <kTwoStreams, kAdd>, by their mangled template arguments
T1_RANDINT_VARIANTS = {"randint_one_stream": "ILb0ELb0E", "randint_one_stream_add": "ILb0ELb1E",
                       "randint_two_streams": "ILb1ELb0E", "randint_two_streams_add": "ILb1ELb1E"}
# The least instructions an element of each draw needs, counted from the
# function's definition (jax/_src/prng.py _threefry2x32_lowering,
# jax/_src/random.py _randint and _uniform), whatever implements it.  The
# elements of a run share the key and their counter's high word, so the
# count leaves out what a thread computes once for its run: x0's initial
# add (high word + k0), each injection's key word plus round constant, the
# key schedule, the index and the addresses.  Four of the five x0
# injections fold into the next round's add (one three-input add).
THREEFRY2X32_OPS = 1 + 20 * 3 + 5 + 1  # x1's initial add; 20 rounds of add, rotate, xor; 5 x1 injections; the last x0 one
XOR_OPS = 1  # the bits of an element: the xor of the cipher's two words
REMAINDER_OPS = 3  # x % span by the span's reciprocal: high multiply, shift, multiply-subtract (a 32-bit magic)
T1_OPS = {
    "split": THREEFRY2X32_OPS,  # a key is the cipher's two words
    "bits": THREEFRY2X32_OPS + XOR_OPS,
    # mantissa: shift and or as one shift-and-add (their bits do not overlap); subtract 1, fused multiply-add, max
    "uniform": THREEFRY2X32_OPS + XOR_OPS + 1 + 3,
    # multiplier 0: lo + lower % span, one stream
    "randint_one_stream": THREEFRY2X32_OPS + XOR_OPS + REMAINDER_OPS + 1,
    # lo + ((higher % span) * mult + lower % span) % span: two streams, three remainders, a multiply-add, an add
    "randint_two_streams": 2 * (THREEFRY2X32_OPS + XOR_OPS) + 3 * REMAINDER_OPS + 1 + 1,
}
# The first T1 design's yardstick for a randint element, logged beside the
# function's count: that kernel's SASS, 330 a thread, less its split
# kernel's 90 twice (the key split each of its threads repeated)
SASS_YARDSTICK_RANDINT_OPS = 150

# phases 12-13: the exact full-view engine (sim/fullview.py) and the lockstep
# gate (sim/conformance.py) with kernels C1 (csrc/threefry.cu) and F1
# (csrc/fullview.cu); pinned from the JAX package (ringpop_tpu.sim.fullview)
# run on the CPU; tests/test_torch_chip_smoke_pins_fullview.py recomputes them
FV_ROWS = (1, 31, 33, 1000, 4097, 8192)
FV_DENSITIES = (0.01, 0.5, 0.99)
FV_FOLD_DATA = (0, 1, 5, 2**31 - 1, 2**32 - 1)
C1_BIG = (1432, 3, 1_000_000)  # a [1432, 3, 1M] draw: its counters pass 2**32 in row 1431
# draws whose counters pass 2**32 inside one of C1's runs (N not a multiple
# of the run): at rows 1431 and 143151
C1_MIDRUN = ((1432, 3, 1_000_003), (143_152, 3, 10_001))
# long rows: a warp draws thousands of runs of each (row, rep)
FV_WIDE = ((7, 16_385), (64, 20_003))
FV_F1_ROWS = (1, 3, 31, 33, 1000)  # F1's phase-12 planes, and FV_BIG_N + 1
# the compare-and-select of a C1 element beyond its bits: the shift to the
# top 23 bits and the compare with the thread's largest (a new largest, and
# its index, is taken about log N times a row, not once an element)
C1_SELECT_OPS = 2
FV_GATE = dict(n=1000, seed=7, suspect_ticks=4, faulty_ticks=30, tombstone_ticks=8)
FV_GATE_DOWN = (99, 499, 999)
FV_GATE_TICKS, FV_GATE_HEALED, FV_GATE_CHECK_EVERY = 12, 8, 4
# BASELINE config 2's shape (ringpop_tpu/cli/simbench.py:bench_loss1k) on fullview
FV_LOSS_N, FV_LOSS_VICTIMS, FV_LOSS_DROP, FV_SUSPECT_TICKS = 1000, 10, 0.05, 25
FV_MAX_TICKS = 200
PIN_FV_LOSS_TICKS = 35
PIN_FV_LOSS = {
    "status": "84dc9f899ddf84805f3585751abcf4d5c610825928e021eacc1297447688fe92",
    "incarnation": "8dbe5f139fd946d4cd84e8cc612cd9f68cbc87e394457884acc0c5dad56dd8dd",
    "present": "1fb6a051d8996888485d47fea0007a88e1e78ea273fa5fb60e1ab00608dbb764",
    "has_change": "4d366612294e36cd2f13740d8ca6608516723b773f9355410bd27bf013dff84b",
    "pcount": "72cb252dda2257b3bd409fae17876d1ec8aaf4b6897d8c042150806b44c69b2f",
    "pending": "da989cf925f1570c64a6186574e3da79f6ed9536b8a617b2d0747c1ce2d45e5b",
    "deadline": "1e24b17100ceeca67eeb297b0d5f37a5da4973a1c4ef39106a253dcf342867e5",
    "tick": "d2d27d69fc0a2c6cc0aabec462ce665aa8a92766844f081b672588acdf8a2c71",
    "key": "eb1ea1a81e08ceab8969c4b8e950bb6412dc22084777557c0f8343e1ca16bb2c",
}
# the same recipe at a size that loads the card: 41 victims of 4096, 16 ticks
FV_BIG_N, FV_BIG_VICTIMS, FV_BIG_TICKS, FV_BLOCK_TICKS = 4096, 41, 16, 8
PIN_FV_BIG = {
    "status": "990d384f762c3a3800d24ef9368c5b80af22d488da72d94952812fca8c31e927",
    "incarnation": "969c6c4a1b47e5f57c25c37ed7ac4b7e87ef885fab94a0e71454c6b979d82b46",
    "present": "b70a752bfdf8d3446d286dc7562cc34093f611be1c88867c062b35b442b0bd04",
    "has_change": "53df6ebf2e5e044504c01a8d6b1fa6b536e9f39e573ea073b772f0abbd635ba0",
    "pcount": "9d8aac10ae0c4a108987c9aa3dd81e59575446a3f7c12bdec34daf2b9e08d237",
    "pending": "aae2b56426bbdb96b9430345ec09632194c6f5aa9f4b9d74a8002743565626ca",
    "deadline": "ea3ef7149b02092d11217f8fc35cf3c1bd60f4d31f075fefc82802cdd3de9a31",
    "tick": "097328e8c957de2428283954f6a1ee8ff7ad7def12e100a600178407f5decf24",
    "key": "68b08a4e5cbe2cc2769ee30a8a99b8f43c1a72e7cd8e2ed54a1bd837199a36f2",
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def uuid_keys(rng: np.random.Generator, n: int) -> tuple[np.ndarray, np.ndarray]:
    """n keys "trip:xxxxxxxx-xxxx-xxxx-xxxx-xxxxxxxxxxxx" packed as
    ``pack_strings`` would: uint8[n, 45], lens int64[n] = 41."""
    mat = np.zeros((n, KEY_LEN + 4), np.uint8)
    mat[:, :5] = np.frombuffer(b"trip:", np.uint8)
    hexd = np.frombuffer(b"0123456789abcdef", np.uint8)
    cols = [5 + i for i in range(36) if i not in (8, 13, 18, 23)]
    mat[:, cols] = hexd[rng.integers(0, 16, size=(n, 32))]
    mat[:, [5 + 8, 5 + 13, 5 + 18, 5 + 23]] = ord("-")
    return mat, np.full(n, KEY_LEN, np.int64)


def host_owner(tokens: np.ndarray, owners: np.ndarray, hashes: np.ndarray) -> np.ndarray:
    idx = np.searchsorted(tokens.astype(np.uint32), hashes.astype(np.uint32), side="left")
    idx[idx == tokens.shape[0]] = 0
    return owners[idx]


def as_np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def time_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median over ``reps`` runs of ``fn`` in ms (CUDA events), with the L2
    cache flushed before each run; one untimed warm-up run first."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiler_warmup() -> None:
    """The opening of a profiler session: WARMUP_MARKS short spin kernels
    (``torch.cuda._sleep``, named MARK_TAG), each waited for.  The profiler
    drops the device records of the first work a session sees (up to 6 of
    20 reps, or ~48 launches of a tick, by the end of a run whose sessions
    start with the measured work), so that work comes after these."""
    for _ in range(WARMUP_MARKS):
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()


def profile_ms(fn, reps: int, flush, flush_tag: str) -> dict[str, tuple[int, float]]:
    """Device time of each kernel that ``fn`` launches, by kernel name, from
    ``torch.profiler`` over ``reps`` runs with ``flush()`` (which evicts the
    L2 cache) before each, after one untimed warm-up run and the session's
    ``profiler_warmup``: {name: (launches, mean ms per launch)}.  The
    flush's own kernels, named with ``flush_tag``, and the marks are left
    out.  A profile whose record misses a flush or a launch of the reps is
    run again, twice at most, then fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiler_warmup()
            for _ in range(reps):
                flush()
                fn()
            torch.cuda.synchronize()
        flush_kernels = marks = 0
        found = {}
        for evt in prof.key_averages():
            us = evt.self_device_time_total
            # device activities that are not kernels (CUPTI's buffer
            # requests, module loading) carry no signature
            if evt.device_type != torch.autograd.DeviceType.CUDA or us <= 0 or "(" not in evt.key:
                continue
            if MARK_TAG in evt.key:
                marks += evt.count
            elif flush_tag in evt.key:
                flush_kernels += evt.count
            else:
                found[evt.key] = (evt.count, us / evt.count / 1e3)
        if flush_kernels >= reps and all(n % reps == 0 for n, _ in found.values()):
            return found
        log(f"profile: the profiler recorded {flush_kernels} of {reps} flushes, {marks} of {WARMUP_MARKS} "
            f"marks and {[n for n, _ in found.values()]} launches; profiling again")
    raise SystemExit(f"chip_smoke FAILED: profiler saw {flush_kernels} of the {reps} flushes")


def kernel_alone(found: dict[str, tuple[int, float]], reps: int) -> tuple[float, float]:
    """(Fingerprint32 kernel's mean ms per launch, the other kernels' ms per
    call) from :func:`profile_ms`'s record of ``reps`` wrapper calls."""
    fp = [(n, ms) for name, (n, ms) in found.items() if "fingerprint32" in name]
    check(len(fp) == 1 and fp[0][0] == reps,
          f"profiler shows the Fingerprint32 kernel once per call: {sorted(found)}")
    others = sum(n * ms for name, (n, ms) in found.items() if "fingerprint32" not in name)
    return fp[0][1], others / reps


def random_keys(rng: np.random.Generator, n: int, width: int) -> tuple[np.ndarray, np.ndarray]:
    """n random-byte keys of length width-4, packed as ``pack_strings``
    would: uint8[n, width] with 4 zero bytes after each key."""
    mat = np.zeros((n, width), np.uint8)
    mat[:, : width - 4] = rng.integers(0, 256, size=(n, width - 4), dtype=np.uint8)
    return mat, np.full(n, width - 4, np.int64)


def kernel_profile(dev: torch.device, widths=(45, 64, 128), n_keys: int = N_KEYS) -> dict:
    """The Fingerprint32 wrapper at n_keys x W for each W: its kernel alone
    (profiler) and the whole wrapper call (CUDA events), with the byte
    bound (key matrix + int32 lengths + int64 hashes) and the share of it.
    W = 45 hashes the main path's UUID keys, other widths random bytes.

    The L2 cache is flushed before each run as ``time_ms`` does, by zeroing
    a 256 MiB buffer, which leaves the L2 full of dirty lines that the
    kernel's reads then evict to device memory; the kernel alone is also
    timed after a flush that reads the buffer (clean lines, evicted for
    free), which charges it with its own bytes only."""
    rng = np.random.default_rng(SEED + 2)
    buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    dirty, clean = buf.zero_, lambda: buf.sum(dtype=torch.int64)
    out = {}
    for w in widths:
        mat, lens = uuid_keys(rng, n_keys) if w == KEY_LEN + 4 else random_keys(rng, n_keys, w)
        dmat, dlens = upload_keys(mat, lens, dev)
        fn = lambda: hash_kernel.fingerprint32_cuda(dmat, dlens)  # noqa: E731
        found = profile_ms(fn, 20, dirty, "FillFunctor")
        k_ms, other_ms = kernel_alone(found, 20)
        clean_ms, _ = kernel_alone(profile_ms(fn, 20, clean, "reduce_kernel"), 20)
        bound_ms = (n_keys * w + 4 * n_keys + 8 * n_keys) / HBM_BYTES_PER_S * 1e3
        rec = out[str(w)] = {
            "kernel_ms": k_ms, "kernel_ms_clean_l2": clean_ms, "other_kernels_ms": other_ms,
            "call_ms": time_ms(fn, 20, buf), "bound_ms": bound_ms,
            "share_of_bound": bound_ms / k_ms, "share_of_bound_clean_l2": bound_ms / clean_ms,
            "kernels": {name: {"launches": n, "ms": ms} for name, (n, ms) in found.items()},
        }
        log(f"profile: B={n_keys} W={w}: kernel alone {k_ms * 1e3:.2f} us "
            f"({clean_ms * 1e3:.2f} us after a clean flush), other kernels "
            f"{other_ms * 1e3:.2f} us, call {rec['call_ms'] * 1e3:.2f} us, bound "
            f"{bound_ms * 1e3:.2f} us ({bound_ms / k_ms:.1%}; {bound_ms / clean_ms:.1%})")
    return out


def check_case(dmat: torch.Tensor, dlens: torch.Tensor, mat: np.ndarray, lens: np.ndarray,
               what: str) -> int:
    """The kernel == the plain version on the card == the numpy farm on the
    host, bit for bit, for one key matrix; returns the max abs difference."""
    want = fingerprint32_batch(mat, lens).astype(np.int64)
    got = hash_kernel.fingerprint32_cuda(dmat, dlens)
    plain = fingerprint32_device(dmat, dlens)
    torch.cuda.synchronize()
    b, w = dmat.shape
    check(got.dtype == torch.int64 and got.shape == (b,), f"kernel output int64[B] ({what})")
    err = int((got - plain).abs().max()) if b else 0
    check(torch.equal(got, plain), f"kernel == plain at B={b} W={w} ({what})")
    check(np.array_equal(as_np(got), want), f"kernel == numpy farm at B={b} W={w} ({what})")
    log(f"phase1: B={b} W={w} {what}: kernel == plain == numpy farm (tolerance: none, bit-equal)")
    return err


def random_strings(rng: np.random.Generator, n: int, max_len: int) -> tuple[np.ndarray, np.ndarray]:
    """n random-byte strings of random lengths 0..max_len (max_len once),
    packed: uint8[n, max_len + 4]."""
    lengths = rng.integers(0, max_len + 1, size=n)
    lengths[0] = max_len
    return pack_strings([rng.integers(0, 256, size=n_, dtype=np.uint8).tobytes() for n_ in lengths])


def at_offset(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of ``x`` that starts ``offset`` bytes (a multiple
    of its element size) into its storage, so its base is not 16-byte
    aligned for offset % 16 != 0."""
    nbytes = x.numel() * x.element_size()
    flat = torch.zeros(offset + nbytes + 16, dtype=torch.uint8, device=x.device)
    view = flat[offset: offset + nbytes].view(x.dtype).view(x.shape)
    view.copy_(x)
    check(view.is_contiguous() and view.data_ptr() % 16 == offset % 16, "offset view")
    return view


def phase1_kernel_vs_plain(dev: torch.device) -> int:
    """Kernel == plain version == numpy copy over every length class, ragged
    B and W, bases that are not 16-byte aligned, the bank-conflict widths,
    int64 lengths and the wide route."""
    rng = np.random.default_rng(SEED)
    strings = [
        rng.integers(0, 256, size=length, dtype=np.uint8).tobytes()
        for length in range(131) for _ in range(64)
    ]
    lengths = np.array([len(s) for s in strings])
    max_err = 0
    # (longest key, extra zero columns, rows dropped from the end)
    for max_len, extra, drop in ((130, 0, 5), (41, 0, 7), (41, 2, 1), (24, 1, 3)):
        sub = [s for s, n in zip(strings, lengths) if n <= max_len][: -drop]
        mat, lens = pack_strings(sub)
        mat = np.pad(mat, ((0, 0), (0, extra)))
        b, w = mat.shape
        check(w % 4 != 0 and b % 32 != 0, f"corpus shape {b}x{w} is meant to be ragged")
        check(int((mat >= 0x80).sum()) > 0, "corpus holds bytes >= 0x80")
        dmat, dlens = upload_keys(mat, lens, dev)
        max_err = max(max_err, check_case(dmat, dlens, mat, lens, "corpus"))
        if (max_len, extra) == (41, 0):
            uuid_case = (mat, lens, dmat, dlens)

    mat, lens, dmat, dlens = uuid_case
    for offset in (1, 7, 15):
        max_err = max(max_err, check_case(at_offset(dmat, offset), dlens, mat, lens,
                                          f"base at storage offset {offset}"))
    for b in (1, 257):
        max_err = max(max_err, check_case(dmat[:b], dlens[:b], mat[:b], lens[:b], f"B={b}"))
        max_err = max(max_err, check_case(at_offset(dmat[:b], 3), dlens[:b], mat[:b], lens[:b],
                                          f"B={b}, base at storage offset 3"))
    max_err = max(max_err, check_case(dmat, dlens.to(torch.int64), mat, lens, "int64 lens"))
    for w in (64, 128):
        mat, lens = random_strings(rng, 3001, w - 4)
        dmat, dlens = upload_keys(mat, lens, dev)
        rows, stages, smem, route = hash_kernel.plan_tiles(w)
        check(route == "staged", f"W={w} takes the staged route")
        what = f"{rows} rows x {stages} stages, pad_shift {hash_kernel.pad_shift(w)}"
        max_err = max(max_err, check_case(dmat, dlens, mat, lens, what))
        max_err = max(max_err, check_case(at_offset(dmat, 7), dlens.to(torch.int64), mat, lens,
                                          "int64 lens, base at storage offset 7"))
    # wide route: not even a 32-row stage fits in shared memory
    mat, lens = random_strings(rng, 67, 8196)
    check(hash_kernel.plan_tiles(mat.shape[1])[3] == "wide", "W=8200 takes the wide route")
    dmat, dlens = upload_keys(mat, lens, dev)
    wide_before = hash_kernel.route_launches["wide"]
    max_err = max(max_err, check_case(dmat, dlens, mat, lens, "wide route"))
    max_err = max(max_err, check_case(at_offset(dmat, 5), dlens.to(torch.int64), mat, lens,
                                      "wide route, int64 lens, base at storage offset 5"))
    check(hash_kernel.route_launches["wide"] == wide_before + 2, "the wide route launched")
    return max_err


# -- the delta engine: packed-plane kernels and the SWIM dissemination path --


def leaf_digests(leaves, fields=delta.DeltaState._fields) -> dict[str, str]:
    """sha256 of each state leaf (numpy, in the JAX package's dtypes:
    uint32 planes and key, int8 counters, int32 tick) over its
    little-endian bytes (``bench.leaf_digests``)."""
    return bench.leaf_digests(leaves, fields)


def uniform_down_nodes(n: int) -> np.ndarray:
    """The nodes that are down in phase 7's configuration."""
    return np.random.default_rng(UNIFORM_DOWN_SEED).choice(n, UNIFORM_DOWN, replace=False)


def reduce_plain(p: torch.Tensor, op: str, rows=None) -> torch.Tensor:
    fn = packbits.or_reduce_rows_plain if op == "or" else packbits.and_reduce_rows_plain
    return fn(p, rows)


@contextlib.contextmanager
def plain_packbits():
    """Route ``sim/packbits``'s reduces and popcount on CUDA tensors to their
    plain versions (on the card) for the duration: the delta path with no
    kernel of this slice."""
    saved = packbits_kernel.reduce_rows_cuda, packbits_kernel.popcount_rows_cuda
    packbits_kernel.reduce_rows_cuda = reduce_plain
    packbits_kernel.popcount_rows_cuda = packbits.popcount_rows_plain
    try:
        yield
    finally:
        packbits_kernel.reduce_rows_cuda, packbits_kernel.popcount_rows_cuda = saved


def random_plane(gen: torch.Generator, n: int, w: int, kind: str, dev) -> torch.Tensor:
    """int32[n, w] plane packed from K = 32w - 5 slots (tail bits zero):
    ``sparse`` bits (a column's OR is 0 with probability 1/2), ``dense``
    bits (a column's AND is 1 with probability 1/2) or ``random`` (p = 1/2)."""
    k = 32 * w - 5
    q = 1.0 - 0.5 ** (1.0 / n)
    density = {"sparse": q, "dense": 1.0 - q, "random": 0.5}[kind]
    return packbits.pack_bool(torch.rand((n, k), generator=gen, device=dev) < density)


def check_packbits_case(p: torch.Tensor, rows, what: str) -> int:
    """S1 (OR and AND) and S2 == their plain versions on one plane; returns
    the max abs difference (of the int32 words)."""
    err = 0
    for op in ("or", "and"):
        got = packbits_kernel.reduce_rows_cuda(p, op, rows)
        want = reduce_plain(p, op, rows)
        err = max(err, int((got.long() - want.long()).abs().max()))
        check(torch.equal(got, want), f"row reduce {op} == plain ({what})")
    if rows is None:
        got = packbits_kernel.popcount_rows_cuda(p)
        want = packbits.popcount_rows_plain(p)
        check(got.dtype == torch.int32 and got.shape == (p.shape[0],), f"popcount int32[N] ({what})")
        err = max(err, int((got - want).abs().max()))
        check(torch.equal(got, want), f"popcount == plain ({what})")
    return err


def phase5_packbits(dev: torch.device) -> int:
    """S1 and S2 bit-equal to their plain versions on the card; each
    wrapper's launch count checked.  Returns the max abs difference."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    packbits_kernel.reset_launches()
    calls = {"row_reduce": 0, "popcount_rows": 0}
    max_err = 0
    for n in PACKBITS_ROWS:
        for w in PACKBITS_WIDTHS:
            rows_rand = torch.rand(n, generator=gen, device=dev) < 0.5
            masks = {"no mask": None, "random mask": rows_rand,
                     "all-false mask": torch.zeros(n, dtype=torch.bool, device=dev),
                     "all-true mask": torch.ones(n, dtype=torch.bool, device=dev)}
            for kind in ("sparse", "dense", "random"):
                p = random_plane(gen, n, w, kind, dev)
                for mname, rows in masks.items():
                    max_err = max(max_err, check_packbits_case(p, rows, f"N={n} W={w} {kind}, {mname}"))
                    calls["row_reduce"] += 2
                    calls["popcount_rows"] += rows is None
            log(f"phase5: N={n} W={w}: row reduce OR/AND and popcount == plain "
                f"(3 planes x 4 masks; tolerance: none, bit-equal)")
    # a base 4 bytes past a 16-byte boundary (one-word loads), and a plane
    # wider than one block's 256 four-word columns (two column tiles)
    for n, w, offset in ((4097, 4, 1), (4097, 8, 1), (33, 1032, 0)):
        flat = random_plane(gen, n * w + offset, 1, "random", dev).reshape(-1)
        p = flat[offset:].view(n, w)
        vec = packbits_kernel.vec_words(w, p.data_ptr())
        check(vec == (1 if offset else 4), f"N={n} W={w} at +{4 * offset} bytes: {vec}-word loads")
        for mname, rows in (("no mask", None), ("random mask", torch.rand(n, generator=gen, device=dev) < 0.5)):
            what = f"N={n} W={w}, base at +{4 * offset} bytes, {mname}"
            max_err = max(max_err, check_packbits_case(p, rows, what))
            calls["row_reduce"] += 2
            calls["popcount_rows"] += rows is None
            log(f"phase5: {what}: == plain")
    torch.cuda.synchronize()
    check(packbits_kernel.launches == calls,
          f"one launch per wrapper call: {packbits_kernel.launches} vs {calls}")
    log(f"phase5: launches {packbits_kernel.launches}; max abs err {max_err}")
    return max_err


def packbits_profile(dev: torch.device) -> dict:
    """S1 and S2 alone (profiler, by name) at the delta path's shapes, after
    a flush that leaves the L2 cache clean, and after none (the tick's
    reduces read a plane it has just written); the wrapper calls and the
    plain versions by CUDA events; each beside its byte bound."""
    n, w = DELTA_N, packbits.n_words(DELTA_K)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    p = random_plane(gen, n, w, "random", dev)
    rows = torch.rand(n, generator=gen, device=dev) < 0.999
    buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    clean = lambda: buf.sum(dtype=torch.int64)  # noqa: E731
    tiny = torch.empty(1, dtype=torch.int32, device=dev)  # a tagged no-op between warm runs
    cases = {
        "row_reduce_or": (lambda: packbits_kernel.reduce_rows_cuda(p, "or"),
                          lambda: reduce_plain(p, "or"), 4 * n * w + 4 * w),
        "row_reduce_and_masked": (lambda: packbits_kernel.reduce_rows_cuda(p, "and", rows),
                                  lambda: reduce_plain(p, "and", rows), 4 * n * w + n + 4 * w),
        "popcount_rows": (lambda: packbits_kernel.popcount_rows_cuda(p),
                          lambda: packbits.popcount_rows_plain(p), 4 * n * w + 4 * n),
    }
    out = {}
    for name, (fn, plain, nbytes) in cases.items():
        kname = "packbits_popcount_rows" if name == "popcount_rows" else "packbits_row_reduce"
        found = profile_ms(fn, 20, clean, "reduce_kernel")
        ms = [v[1] for key, v in found.items() if kname in key]
        check(len(ms) == 1, f"profiler shows {kname} once: {sorted(found)}")
        warm = profile_ms(fn, 20, tiny.zero_, "FillFunctor")
        warm_ms = [v[1] for key, v in warm.items() if kname in key]
        check(len(warm_ms) == 1, f"profiler shows {kname} once (warm): {sorted(warm)}")
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rec = out[name] = {
            "kernel_ms": ms[0], "kernel_ms_warm_l2": warm_ms[0],
            "call_ms": time_ms(fn, 20, buf), "plain_ms": time_ms(plain, 10, buf),
            "bound_ms": bound_ms, "share_of_bound": bound_ms / ms[0], "bytes": nbytes,
        }
        log(f"profile: {name} N={n} W={w}: kernel alone {ms[0] * 1e3:.2f} us after a clean "
            f"flush, {rec['kernel_ms_warm_l2'] * 1e3:.2f} us warm; call {rec['call_ms'] * 1e3:.2f} us; "
            f"plain {rec['plain_ms']:.4f} ms; bound {bound_ms * 1e3:.2f} us ({bound_ms / ms[0]:.1%})")
    return out


def delta_block_profile(params, state, faults, ticks: int) -> dict:
    """``torch.profiler`` over ``ticks`` ticks from ``state``: device time by
    kernel name (top 10) and by phase range, the window (CUDA events) and
    the device's busy share of it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ticks):
            state = delta.step(params, state, faults)
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end)
    kernels, phases, spans = {}, {}, {}
    for evt in prof.key_averages():
        on_device = evt.device_type == torch.autograd.DeviceType.CUDA
        if evt.key in delta.PHASES:
            # a range appears twice: on the host, with the device time of
            # the kernels it launched, and on the device, as the span from
            # its first kernel's start to its last one's end (gaps included)
            if on_device:
                spans[evt.key] = evt.self_device_time_total / 1e3
            else:
                phases[evt.key] = evt.device_time_total / 1e3
        elif on_device and evt.self_device_time_total > 0:
            kernels[evt.key] = (evt.count, evt.self_device_time_total / 1e3)
    busy_ms = sum(ms for _, ms in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "ticks": ticks, "window_ms": window_ms, "device_busy_ms": busy_ms,
        "busy_share": busy_ms / window_ms, "idle_share": 1.0 - busy_ms / window_ms,
        "kernel_launches": sum(c for c, _ in kernels.values()),
        "phases_kernel_ms": phases, "phases_span_ms": spans,
        "packbits_kernels": {name: {"launches": c, "ms": ms} for name, (c, ms) in kernels.items()
                             if "packbits_" in name},
        "top_kernels": [{"name": name[:160], "launches": c, "ms": ms} for name, (c, ms) in top],
    }


def phase6_delta_shift(dev: torch.device) -> dict:
    """The delta path at 1M x 128 (shift): kernels vs plain reduces for 8
    ticks, then the counted, timed convergence run against the JAX pins."""
    params = delta.DeltaParams(n=DELTA_N, k=DELTA_K, exchange="shift", rng="counter")
    t0 = time.perf_counter()
    a = delta.init_state(params, seed=DELTA_SEED, device=dev)
    b = a
    for t in range(8):
        a = delta.step(params, a)
        before = dict(packbits_kernel.launches)
        with plain_packbits():
            b = delta.step(params, b)
        check(packbits_kernel.launches == before, "the plain twin launched no kernel")
        for name, x, y in zip(delta.DeltaState._fields, a, b):
            check(torch.equal(x, y), f"tick {t + 1}: {name} on the kernels == on the plain reduces")
    torch.cuda.synchronize()
    log(f"phase6: 8 ticks at {DELTA_N} x {DELTA_K}: every leaf on the kernels == on the plain "
        f"reduces at every tick ({time.perf_counter() - t0:.1f} s with the warm-up)")

    # -- the main path: launch counts are 0 before it and read right after --
    walls = []
    for run_i in range(3):
        state0 = delta.init_state(params, seed=DELTA_SEED, device=dev)
        torch.cuda.synchronize()
        if run_i == 0:
            packbits_kernel.reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, ticks, ok = delta.run_until_converged(
            params, state0, max_ticks=DELTA_MAX_TICKS, check_every=DELTA_CHECK_EVERY)
        end.record()
        torch.cuda.synchronize()
        walls.append(start.elapsed_time(end))
        if run_i == 0:
            frac = float(delta.converged_fraction(state))
            launches = dict(packbits_kernel.launches)
            final = state
    check(ok and ticks == PIN_SHIFT_TICKS, f"converged in {ticks} ticks (JAX: {PIN_SHIFT_TICKS})")
    check(frac == 1.0, f"converged_fraction {frac} == 1.0")
    digests = leaf_digests(delta.state_to_numpy(final))
    for name, want in PIN_SHIFT.items():
        check(digests[name] == want, f"final {name} digest == the JAX package's")
    blocks = PIN_SHIFT_TICKS // DELTA_CHECK_EVERY
    check(launches == {"row_reduce": 2 * PIN_SHIFT_TICKS + blocks + 1, "popcount_rows": 1},
          f"the delta path launched S1 twice a tick + once a check and S2 once: {launches}")
    log(f"phase6: converged in {ticks} ticks == JAX; final leaf digests == JAX; "
        f"launches {launches}; wall {[round(w, 3) for w in walls]} ms")
    profile = delta_block_profile(params, delta.init_state(params, seed=DELTA_SEED, device=dev),
                                  delta.DeltaFaults(), DELTA_CHECK_EVERY)
    log(f"phase6: one {DELTA_CHECK_EVERY}-tick block: window {profile['window_ms']:.3f} ms, device "
        f"busy {profile['device_busy_ms']:.3f} ms ({profile['busy_share']:.1%}), "
        f"{profile['kernel_launches']} kernel launches; kernel ms by phase {profile['phases_kernel_ms']}; "
        f"span ms by phase {profile['phases_span_ms']}; this slice's kernels {profile['packbits_kernels']}")
    for rec in profile["top_kernels"]:
        log(f"phase6:   {rec['ms']:.4f} ms  x{rec['launches']}  {rec['name'][:110]}")
    return {
        "launches": launches, "ticks": ticks, "converged_fraction": frac,
        "wall_ms": walls, "ms_per_tick": [w / ticks for w in walls], "block_profile": profile,
    }


def phase7_delta_uniform(dev: torch.device) -> dict:
    """The uniform exchange with 1000 nodes down and drop_rate 0.01 at
    1M x 128 for 24 ticks: final leaf digests == the JAX pins."""
    params = delta.DeltaParams(n=DELTA_N, k=DELTA_K, exchange="uniform", rng="counter")
    up = np.ones(DELTA_N, bool)
    up[uniform_down_nodes(DELTA_N)] = False
    faults = delta.DeltaFaults(up=torch.from_numpy(up).to(dev),
                               drop_rate=torch.tensor(UNIFORM_DROP, dtype=torch.float32, device=dev))
    state = delta.init_state(params, seed=DELTA_SEED, device=dev)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(UNIFORM_TICKS):
        state = delta.step(params, state, faults)
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    digests = leaf_digests(delta.state_to_numpy(state))
    for name, want in PIN_UNIFORM.items():
        check(digests[name] == want, f"uniform: final {name} digest == the JAX package's")
    frac = float(delta.converged_fraction(state, faults))
    check(frac == 1.0 and bool(delta.converged(state, faults)), f"uniform: converged ({frac})")
    log(f"phase7: uniform, {UNIFORM_DOWN} down, drop {UNIFORM_DROP}: {UNIFORM_TICKS} ticks in "
        f"{wall:.3f} ms; final leaf digests == JAX; converged")
    return {"ticks": UNIFORM_TICKS, "wall_ms": wall, "ms_per_tick": wall / UNIFORM_TICKS}


def run_delta(dev: torch.device) -> tuple[list, dict]:
    """Phases 5-7 on ``dev``; returns the kernels' records and the timings."""
    max_err = phase5_packbits(dev)
    prof = packbits_profile(dev)
    shift = phase6_delta_shift(dev)
    uniform = phase7_delta_uniform(dev)
    launches = shift["launches"]
    kernels = []
    for name, key, cases, line in (
        ("packbits_row_reduce", "row_reduce", ("row_reduce_or", "row_reduce_and_masked"),
         "ringpop_tpu/sim/packbits.py:181"),
        ("packbits_popcount_rows", "popcount_rows", ("popcount_rows",),
         "ringpop_tpu/sim/packbits.py:126"),
    ):
        rec = prof[cases[0]]  # the delta path's shape: no row mask
        kernels.append({
            "name": name, "route": "cuda", "source": "ringpop_tpu_torch/csrc/packbits.cu",
            "replaces": line, "launches": launches[key], "max_abs_err": max_err,
            "ms": rec["kernel_ms"], "ms_warm_l2": rec["kernel_ms_warm_l2"], "call_ms": rec["call_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "share_of_bound": rec["share_of_bound"], "bound_by": "bytes", "library_ms": None,
            "by_case": {c: prof[c] for c in cases},
        })
    return kernels, {"delta_shift": shift, "delta_uniform": uniform}


# -- the lifecycle engine: the slot-walk and first-live-learner kernels and --
# -- SWIM failure detection at bench.py's headline scale --------------------


@contextlib.contextmanager
def plain_lifecycle():
    """Route ``ops/lifecycle_kernel``'s walk and first-live-learner on CUDA
    tensors, and ``sim/packbits``'s reduces, to their plain versions (on
    the card) for the duration: the lifecycle path with no kernel."""
    saved = lifecycle_kernel.slot_walk_cuda, lifecycle_kernel.first_live_learner_cuda
    lifecycle_kernel.slot_walk_cuda = lifecycle_kernel.slot_walk_plain
    lifecycle_kernel.first_live_learner_cuda = lifecycle_kernel.first_live_learner_plain
    try:
        with plain_packbits():
            yield
    finally:
        lifecycle_kernel.slot_walk_cuda, lifecycle_kernel.first_live_learner_cuda = saved


def random_rumor_table(gen: torch.Generator, n: int, k: int, dev, kind: str):
    """(r_subject, rkey) for a random K-slot table: about a quarter of the
    slots free, keys of every status (equal keys included); ``kind``
    "single" gives every subject one slot (the headline's shape), "straddle"
    gives a subject each of the two or three slots around every word
    boundary, "many" gives one subject a third of the slots, "full" frees
    no slot, "free" frees every slot."""
    if kind == "single" and n >= k:
        subj = torch.randperm(n, generator=gen, device=dev)[:k].to(torch.int32)
    else:
        subj = torch.randint(0, n, (k,), generator=gen, device=dev, dtype=torch.int32)
    if kind == "straddle":
        for edge in range(32, k, 32):
            span = 2 + (edge // 32) % 2  # slots 31|32, 63|64|65, 95|96, ...
            subj[edge - 1: edge - 1 + span] = subj[edge - 1]
    if kind == "many":
        subj[: k // 3] = subj[0]
    if kind not in ("full", "straddle"):
        free = torch.rand(k, generator=gen, device=dev) < (1.0 if kind == "free" else 0.25)
        subj = torch.where(free, -1, subj)
    inc = torch.randint(0, 4, (k,), generator=gen, device=dev, dtype=torch.int32)
    status = torch.randint(0, 5, (k,), generator=gen, device=dev, dtype=torch.int32)
    rkey = torch.where(subj >= 0, (inc << 3) | status, -1).to(torch.int32)
    return subj, rkey


def random_base_key(gen: torch.Generator, n: int, dev) -> torch.Tensor:
    """int32[n]: a base key per subject, absent (-1) for about a tenth."""
    key = (torch.randint(0, 3, (n,), generator=gen, device=dev, dtype=torch.int32) << 3) | torch.randint(
        0, 5, (n,), generator=gen, device=dev, dtype=torch.int32)
    return torch.where(torch.rand(n, generator=gen, device=dev) < 0.1, -1, key).to(torch.int32)


def random_learned(gen: torch.Generator, n: int, k: int, dev, density: float) -> torch.Tensor:
    """int32[n, W] packed from K random slot bits (tail bits zero); rows
    0 and 1 learn nothing and three slot columns are empty."""
    bits = torch.rand((n, k), generator=gen, device=dev) < density
    bits[:, :3] = False
    bits[:2] = False
    return packbits.pack_bool(bits)


def lone_last_learner(learned: torch.Tensor, up, k: int):
    """(plane, up, slots): ``learned`` with slots 3, k // 2 and k - 1
    learned by the last row alone, which is up — the case where L2 reads
    every row."""
    n = learned.shape[0]
    slots = torch.tensor([3, k // 2, k - 1], device=learned.device)
    bits = packbits.unpack_bits(learned, k)
    bits[:, slots] = False
    bits[n - 1, slots] = True
    up = None if up is None else up.clone()
    if up is not None:
        up[n - 1] = True
    return packbits.pack_bool(bits), up, slots


def check_walk(learned, subj, rkey, base_key, obs_masks, what: str, calls: dict,
               statuses=(SUSPECT, FAULTY)) -> int:
    """L1 in checksum mode and in detect mode (each observer mask x each
    of ``statuses``) == its plain version on the card; returns the max abs
    difference.  The plain version's walk, the part both modes share, runs
    once for all of them (``slot_walk_keys_plain``)."""
    n, k = learned.shape[0], rkey.shape[0]
    order, ss, sk = lifecycle_kernel.walk_order(subj, rkey, n)
    keys, is_last = lifecycle_kernel.slot_walk_keys_plain(learned, order, ss, sk, base_key)
    got = lifecycle_kernel.slot_walk_cuda(learned, order, ss, sk, base_key, "checksum")
    want = lifecycle_kernel.slot_walk_finish_plain(keys, is_last, ss, n, "checksum")
    calls["slot_walk"] += 1
    err = int((got - want).abs().max())
    check(torch.equal(got, want), f"L1 checksum == plain ({what})")
    for oname, obs in obs_masks.items():
        obs = torch.ones(n, dtype=torch.bool, device=learned.device) if obs is None else obs
        for min_status in statuses:
            got = lifecycle_kernel.slot_walk_cuda(learned, order, ss, sk, base_key, "detect", obs, min_status)
            want = lifecycle_kernel.slot_walk_finish_plain(keys, is_last, ss, n, "detect", obs, min_status)
            calls["slot_walk"] += 1
            err = max(err, int((got.int() - want.int()).abs().max()))
            check(torch.equal(got, want), f"L1 detect == plain ({what} {oname} {min_status})")
    return err


def check_learner(learned, up, k: int, want, what: str, calls: dict) -> int:
    """L2 == its plain version on the card; returns the max abs difference."""
    got = lifecycle_kernel.first_live_learner_cuda(learned, up, k, want)
    ref = lifecycle_kernel.first_live_learner_plain(learned, up, k, want)
    calls["first_live_learner"] += 1
    check(torch.equal(got, ref), f"L2 == plain ({what})")
    return int((got - ref).abs().max())


WALK_KINDS = ("single", "straddle", "many", "full", "spread", "free")
WIDEST_ROWS = 8192  # rows at the widest plane: enough for a "single" table of 7008 slots


def widest_planes(dev: torch.device, gen: torch.Generator, calls: dict) -> int:
    """Both kernels at the widest plane they take (MAX_WORDS words, K =
    32 MAX_WORDS): its shared memory fits one block while L2's at one word
    more does not, L1 (single-slot and word-straddling tables) and L2
    (``want`` None and random) == plain, and a plane one word wider is
    refused by both wrappers with no launch.  Returns the max abs
    difference."""
    lib = lifecycle_kernel._library()
    w = lifecycle_kernel.MAX_WORDS
    n, k = WIDEST_ROWS, 32 * w
    optin = getattr(torch.cuda.get_device_properties(dev), "shared_memory_per_block_optin", SMEM_OPTIN)
    smem = {"L1 checksum": lib.rp_slot_walk_smem(w, k, 0), "L1 detect": lib.rp_slot_walk_smem(w, k, 1),
            "L2": lib.rp_first_live_learner_smem(w)}
    check(max(smem.values()) <= optin < lib.rp_first_live_learner_smem(w + 1),
          f"MAX_WORDS = {w} is the widest plane whose tables fit a block ({optin} bytes): {smem}, L2 at "
          f"{w + 1} words {lib.rp_first_live_learner_smem(w + 1)}")
    learned = random_learned(gen, n, k, dev, 0.3)
    base_key = random_base_key(gen, n, dev)
    up = torch.rand(n, generator=gen, device=dev) < 0.7
    err = 0
    # the plain walk takes one step of [N] ops a slot: one pass a table serves both modes
    for kind in ("single", "straddle"):
        subj, rkey = random_rumor_table(gen, n, k, dev, kind)
        err = max(err, check_walk(learned, subj, rkey, base_key, {"random up": up}, f"N={n} K={k} {kind}", calls,
                                  statuses=(FAULTY,)))
    for wname, want in (("want None", None), ("want random", torch.rand(k, generator=gen, device=dev) < 0.3)):
        err = max(err, check_learner(learned, up, k, want, f"N={n} K={k} {wname}", calls))
    wide = torch.zeros((n, w + 1), dtype=torch.int32, device=dev)
    subj, rkey = random_rumor_table(gen, n, 32 * (w + 1), dev, "single")
    order, ss, sk = lifecycle_kernel.walk_order(subj, rkey, n)
    for name, launch in (
            ("slot_walk_cuda", lambda: lifecycle_kernel.slot_walk_cuda(wide, order, ss, sk, base_key, "checksum")),
            ("first_live_learner_cuda", lambda: lifecycle_kernel.first_live_learner_cuda(wide, up, 32 * (w + 1)))):
        try:
            launch()
            check(False, f"{name} refuses a plane of {w + 1} words")
        except ValueError:
            pass
    return err


def phase8_lifecycle_kernels(dev: torch.device) -> int:
    """L1 (both modes) and L2 (want None, empty, all, random, and a lone
    last-row learner) bit-equal to their plain versions on the card at N x
    K in LIFECYCLE_ROWS x LIFECYCLE_SLOTS, and at the widest plane they
    take; launch counts checked.  Returns the max abs difference."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    t0 = time.perf_counter()
    lifecycle_kernel.reset_launches()
    calls = {"slot_walk": 0, "first_live_learner": 0}
    max_err = 0
    for n in LIFECYCLE_ROWS:
        for k in LIFECYCLE_SLOTS:
            base_key = random_base_key(gen, n, dev)
            ups = {"every row": None, "random up": torch.rand(n, generator=gen, device=dev) < 0.7,
                   "all down": torch.zeros(n, dtype=torch.bool, device=dev)}
            wants = {"want None": None, "want empty": torch.zeros(k, dtype=torch.bool, device=dev),
                     "want all": torch.ones(k, dtype=torch.bool, device=dev),
                     "want random": torch.rand(k, generator=gen, device=dev) < 0.3}
            for density in (0.002, 0.3, 0.9):
                learned = random_learned(gen, n, k, dev, density)
                for kind in WALK_KINDS:
                    subj, rkey = random_rumor_table(gen, n, k, dev, kind)
                    max_err = max(max_err, check_walk(learned, subj, rkey, base_key, ups,
                                                      f"N={n} K={k} {density} {kind}", calls))
                for uname, up in ups.items():
                    for wname, want in wants.items():
                        max_err = max(max_err, check_learner(learned, up, k, want,
                                                             f"N={n} K={k} {density} {uname} {wname}", calls))
                lone, lone_up, slots = lone_last_learner(learned, ups["random up"], k)
                only = torch.zeros(k, dtype=torch.bool, device=dev)
                only[slots] = True
                for wname, want in (("want None", None), ("want the lone slots", only)):
                    max_err = max(max_err, check_learner(lone, lone_up, k, want,
                                                         f"N={n} K={k} {density} lone last-row learner {wname}",
                                                         calls))
                ref = lifecycle_kernel.first_live_learner_plain(lone, lone_up, k)
                check(bool((ref[slots] == n - 1).all()), f"the lone slots' only live learner is row {n - 1}")
            log(f"phase8: N={n} K={k}: L1 (checksum; detect x 3 observer masks x SUSPECT/FAULTY) over 3 densities "
                f"x {len(WALK_KINDS)} rumor tables {WALK_KINDS}, L2 (3 up masks x 4 want masks, and a lone "
                f"last-row learner) == plain (tolerance: none, bit-equal; {time.perf_counter() - t0:.1f} s)")
    max_err = max(max_err, widest_planes(dev, gen, calls))
    log(f"phase8: the widest plane, {lifecycle_kernel.MAX_WORDS} words (N={WIDEST_ROWS}, K="
        f"{32 * lifecycle_kernel.MAX_WORDS}): L1 (checksum, detect; single-slot and straddling tables) and L2 "
        f"(want None, random) == plain; {lifecycle_kernel.MAX_WORDS + 1} words refused by both "
        f"({time.perf_counter() - t0:.1f} s)")
    torch.cuda.synchronize()
    check(lifecycle_kernel.launches == calls,
          f"one launch per wrapper call: {lifecycle_kernel.launches} vs {calls}")
    log(f"phase8: launches {lifecycle_kernel.launches}; max abs err {max_err}")
    return max_err


def headline_victims(n: int) -> np.ndarray:
    """bench.py's headline victims: 0.1% of the nodes (bench.py:435-440)."""
    return np.sort(np.random.default_rng(0).choice(n, size=LIFE_VICTIMS, replace=False))


def headline_faults(dev: torch.device, n: int):
    """The headline's victims and its faults: the victims down."""
    victims = headline_victims(n)
    up = np.ones(n, bool)
    up[victims] = False
    return victims, delta.DeltaFaults(up=torch.from_numpy(up).to(dev))


@contextlib.contextmanager
def record_learner_calls(calls: list):
    """Keep each ``first_live_learner`` call's inputs and output (references:
    no copy, no launch) in ``calls`` for the duration."""
    real = lifecycle_kernel.first_live_learner

    def recorded(learned, up, k, want=None):
        out = real(learned, up, k, want)
        calls.append((learned, up, k, want, out))
        return out

    lifecycle_kernel.first_live_learner = recorded
    try:
        yield
    finally:
        lifecycle_kernel.first_live_learner = real


def learner_bound_bytes(learned: torch.Tensor, up, k: int, want) -> int:
    """The bytes L2 must move for these inputs: the rows up to the largest
    answer among the wanted slots (every row where a wanted slot has no
    live learner), their up bytes, the K want bytes and the 4K output
    bytes."""
    n, w = learned.shape
    wanted = torch.ones(k, dtype=torch.bool, device=learned.device) if want is None else want
    rows = 0
    if bool(wanted.any()):
        bits = packbits.unpack_bits(learned, k)
        if up is not None:
            bits &= up[:, None]
        if bool((wanted & ~bits.any(0)).any()):
            rows = n
        else:
            first = lifecycle_kernel.first_live_learner_plain(learned, up, k, wanted)
            rows = int(first.max()) + 1
    return rows * (4 * w + (up is not None)) + (k if want is not None else 0) + 4 * k


PORT_KERNELS = {"row_reduce": "packbits_row_reduce", "popcount_rows": "packbits_popcount_rows",
                "slot_walk": "lifecycle_slot_walk", "first_live_learner": "lifecycle_first_live_learner",
                **{f"threefry_{name}": kname for name, kname in T1_KERNELS.items()},
                "threefry_categorical": "threefry_categorical_kernel", "threefry_fold_in": "threefry_fold_in_kernel"}


def port_launches() -> dict[str, int]:
    """The sim kernels' wrapper launch counts, by PORT_KERNELS' names."""
    return {**packbits_kernel.launches, **lifecycle_kernel.launches,
            **{f"threefry_{name}": c for name, c in threefry_kernel.launches.items()}}


def lifecycle_block_profile(params, state, faults, ticks: int):
    """``torch.profiler`` over ``ticks`` ticks from ``state``: device time by
    phase range and by kernel (top 10), the window (CUDA events), the
    device's busy share of it, kernel launches per tick, and L2's device
    time per launch in launch order with each launch's inputs.  The record
    is held against the wrappers' own launch counts, which drop nothing:
    a record that misses a launch of the port's kernels is taken again from
    the same state (``step`` leaves its input as it was), twice at most,
    then fails.  Returns (the state after the ticks, the record)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        calls = []
        before = port_launches()
        with record_learner_calls(calls), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiler_warmup()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = state
            for _ in range(ticks):
                out = lifecycle.step(params, out, faults)
            end.record()
            torch.cuda.synchronize()
        counted = {name: n - before[name] for name, n in port_launches().items()}
        window_ms = start.elapsed_time(end)
        kernels, phases, spans = {}, {}, {}
        marks = 0
        for evt in prof.key_averages():
            on_device = evt.device_type == torch.autograd.DeviceType.CUDA
            if evt.key in lifecycle.PHASES:
                if on_device:
                    spans[evt.key] = evt.self_device_time_total / 1e3
                else:
                    phases[evt.key] = evt.device_time_total / 1e3
            elif on_device and MARK_TAG in evt.key:
                marks += evt.count
            elif on_device and evt.self_device_time_total > 0:
                kernels[evt.key] = (evt.count, evt.self_device_time_total / 1e3)
        recorded = {name: sum(c for key, (c, _) in kernels.items() if kname in key)
                    for name, kname in PORT_KERNELS.items()}
        if recorded == counted:
            break
        log(f"profile: the profiler recorded {recorded} of the port's launches in the block, the wrappers "
            f"counted {counted} ({marks} of {WARMUP_MARKS} marks); profiling the block again")
    else:
        raise SystemExit(f"chip_smoke FAILED: the profiler's record of a {ticks}-tick block misses launches of "
                         f"the port's kernels: {recorded} recorded, {counted} counted")
    learner_ms = sorted(
        ((e.time_range.start, e.time_range.elapsed_us() / 1e3) for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA and "lifecycle_first_live_learner" in e.name))
    busy_ms = sum(ms for _, ms in kernels.values())
    launches = sum(c for c, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return out, {
        "ticks": ticks, "window_ms": window_ms, "device_busy_ms": busy_ms,
        "busy_share": busy_ms / window_ms, "idle_share": 1.0 - busy_ms / window_ms,
        "kernel_launches": launches, "kernel_launches_per_tick": launches / ticks,
        "port_launches": counted, "warmup_marks_recorded": marks,
        "phases_kernel_ms": phases, "phases_span_ms": spans,
        "port_kernels": {name: {"launches": c, "ms": ms} for name, (c, ms) in kernels.items()
                         if any(tag in name for tag in ("packbits_", "lifecycle_", "threefry_"))},
        "top_kernels": [{"name": name[:160], "launches": c, "ms": ms} for name, (c, ms) in top],
        "learner_ms": [ms for _, ms in learner_ms], "learner_calls": calls,
    }


def one_kernel_ms(found: dict, kname: str) -> float:
    ms = [v[1] for key, v in found.items() if kname in key]
    check(len(ms) == 1, f"profiler shows {kname} once: {sorted(found)}")
    return ms[0]


def slot_table_shape(state) -> dict:
    """Slots in flight, subjects holding two or more of them, and those
    subjects' slots (L1's multi-slot list)."""
    live = state.r_subject[state.r_subject >= 0]
    counts = torch.unique(live, return_counts=True)[1] if live.numel() else live
    return {"slots_in_flight": int(live.numel()), "multi_slot_subjects": int((counts >= 2).sum()),
            "multi_slot_entries": int(counts[counts >= 2].sum())}


def lifecycle_profile(dev: torch.device, state, victims, faults) -> dict:
    """L1 (both modes) and L2 (``want=None``) alone (profiler, by name) on a
    headline state after a flush that leaves the L2 cache clean, beside
    their byte bounds; the wrapper calls, the queries and the plain
    versions by CUDA events; the slot table's shape."""
    n, w = state.learned.shape
    k = state.r_subject.shape[0]
    subjects = torch.as_tensor(victims, dtype=torch.int64, device=dev)
    base_key = lifecycle._base_key(state)
    order, ss, sk = lifecycle_kernel.walk_order(state.r_subject, lifecycle._rkey(state), n)
    obs = lifecycle._observers(state, subjects, faults)
    up = faults.up
    buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    clean = lambda: buf.sum(dtype=torch.int64)  # noqa: E731
    out = {**slot_table_shape(state), "tick": int(state.tick)}
    table = 16 * k  # order, subject, key and the base key per slot
    # L1 reads the plane (and, detecting, the observer bytes) only when a slot is in flight
    plane = 4 * n * w if out["slots_in_flight"] else 0
    observers = n if out["slots_in_flight"] else 0
    cases = {
        "slot_walk_detect": (
            lambda: lifecycle_kernel.slot_walk_cuda(state.learned, order, ss, sk, base_key, "detect", obs, FAULTY),
            lambda: lifecycle_kernel.slot_walk_plain(state.learned, order, ss, sk, base_key, "detect", obs, FAULTY),
            "lifecycle_slot_walk", plane + observers + table + n),
        "slot_walk_checksum": (
            lambda: lifecycle_kernel.slot_walk_cuda(state.learned, order, ss, sk, base_key, "checksum"),
            lambda: lifecycle_kernel.slot_walk_plain(state.learned, order, ss, sk, base_key, "checksum"),
            "lifecycle_slot_walk", plane + table + 8 * n),
        "first_live_learner": (
            lambda: lifecycle_kernel.first_live_learner_cuda(state.learned, up, k),
            lambda: lifecycle_kernel.first_live_learner_plain(state.learned, up, k),
            "lifecycle_first_live_learner", learner_bound_bytes(state.learned, up, k, None)),
    }
    for name, (fn, plain, kname, nbytes) in cases.items():
        check(torch.equal(fn(), plain()), f"{name} == plain at tick {out['tick']}")
        ms = one_kernel_ms(profile_ms(fn, 20, clean, "reduce_kernel"), kname)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rec = out[name] = {
            "kernel_ms": ms, "call_ms": time_ms(fn, 20, buf), "plain_ms": time_ms(plain, 3, buf),
            "bound_ms": bound_ms, "share_of_bound": bound_ms / ms, "bytes": nbytes,
        }
        log(f"profile: tick {out['tick']} {name} N={n} K={k}: kernel alone {ms * 1e3:.2f} us after a clean "
            f"flush; call {rec['call_ms'] * 1e3:.2f} us; plain {rec['plain_ms']:.3f} ms; bound "
            f"{bound_ms * 1e3:.2f} us ({bound_ms / ms:.1%})")
    check_fn = lambda: lifecycle.detection_complete(state, subjects, faults)  # noqa: E731
    views_fn = lambda: lifecycle.view_checksums(state, faults)  # noqa: E731
    out["detection_check_ms"] = time_ms(check_fn, 10, buf)
    out["view_checksums_ms"] = time_ms(views_fn, 10, buf)
    with plain_lifecycle():
        out["detection_check_plain_ms"] = time_ms(check_fn, 3, buf)
        out["view_checksums_plain_ms"] = time_ms(views_fn, 3, buf)
    log(f"profile: tick {out['tick']}: {out['slots_in_flight']} of {k} slots in flight, "
        f"{out['multi_slot_subjects']} subjects hold {out['multi_slot_entries']} of them; detection check "
        f"{out['detection_check_ms']:.3f} ms (plain walk {out['detection_check_plain_ms']:.3f} ms); "
        f"view_checksums {out['view_checksums_ms']:.3f} ms (plain {out['view_checksums_plain_ms']:.3f} ms)")
    return out


def learner_planes(dev: torch.device) -> dict:
    """L2 alone (profiler, by name, after a clean flush) on synthetic
    1,000,000 x 256 planes — every slot learned by 30 % or 1 % of the rows,
    a first learner per slot between rows 100,000 and 300,000, and no
    learner at all — with ``want`` None, empty and 5 % of the slots, beside
    the data-dependent byte bound; each launch == plain."""
    n, k = LIFE_N, LIFE_K
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    up = torch.rand(n, generator=gen, device=dev) < 0.999
    late = torch.zeros((n, k), dtype=torch.bool, device=dev)
    late[torch.randint(100_000, 300_000, (k,), generator=gen, device=dev), torch.arange(k, device=dev)] = True
    planes = {
        "dense0.3": packbits.pack_bool(torch.rand((n, k), generator=gen, device=dev) < 0.3),
        "dense0.01": packbits.pack_bool(torch.rand((n, k), generator=gen, device=dev) < 0.01),
        "late": packbits.pack_bool(late),
        "none": torch.zeros((n, k // 32), dtype=torch.int32, device=dev),
    }
    del late
    wants = {"None": None, "empty": torch.zeros(k, dtype=torch.bool, device=dev),
             "5%": torch.rand(k, generator=gen, device=dev) < 0.05}
    buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    clean = lambda: buf.sum(dtype=torch.int64)  # noqa: E731
    out = {}
    for pname, plane in planes.items():
        for wname, want in wants.items():
            fn = lambda: lifecycle_kernel.first_live_learner_cuda(plane, up, k, want)  # noqa: E731
            check(torch.equal(fn(), lifecycle_kernel.first_live_learner_plain(plane, up, k, want)),
                  f"L2 == plain on the {pname} plane, want {wname}")
            ms = one_kernel_ms(profile_ms(fn, 20, clean, "reduce_kernel"), "lifecycle_first_live_learner")
            bound_ms = learner_bound_bytes(plane, up, k, want) / HBM_BYTES_PER_S * 1e3
            out[f"{pname}/{wname}"] = {"kernel_ms": ms, "bound_ms": bound_ms}
            log(f"profile: L2 on the {pname} plane, want {wname}: kernel alone {ms * 1e3:.2f} us after a clean "
                f"flush; bound {bound_ms * 1e3:.2f} us")
    return out


def learner_in_tick(block: dict) -> list[dict]:
    """Each L2 launch of a profiled block: its device ms, whether a timer
    fired, its byte bound; every output == the plain version on the same
    inputs."""
    calls = block.pop("learner_calls")
    times = block.pop("learner_ms")
    check(len(times) == len(calls), f"the profiler timed {len(times)} of the block's {len(calls)} L2 launches")
    launches = []
    for ms, (learned, up, k, want, out) in zip(times, calls):
        check(torch.equal(out, lifecycle_kernel.first_live_learner_plain(learned, up, k, want)),
              "L2 in the tick == plain on the same inputs")
        launches.append({"ms": ms, "fired": bool(want.any()),
                         "bound_ms": learner_bound_bytes(learned, up, k, want) / HBM_BYTES_PER_S * 1e3})
    return launches


def lifecycle_trace(dev: torch.device, params, faults, victims) -> dict:
    """The main path's ticks again, from ``init_state``, in blocks of
    LIFE_CHECK_EVERY under the profiler (by phase and kernel, launches a
    tick, L2 in the tick by launch), and L1/L2 alone on the state of each
    detection check (ticks 32, 64, 96, 128)."""
    state = lifecycle.init_state(params, seed=LIFE_SEED, device=dev)
    blocks, checks, learner = [], [], []
    plain_inputs = None  # a launch's inputs for the plain version's time: the first where a timer fired
    for _ in range(PIN_LIFE_DETECT_TICKS // LIFE_CHECK_EVERY):
        state, block = lifecycle_block_profile(params, state, faults, LIFE_CHECK_EVERY)
        if plain_inputs is None or not bool(plain_inputs[3].any()):
            plain_inputs = next((c[:4] for c in block["learner_calls"] if bool(c[3].any())),
                                plain_inputs or block["learner_calls"][0][:4])
        learner += learner_in_tick(block)
        blocks.append(block)
        log(f"phase9: ticks to {int(state.tick)}: window {block['window_ms']:.3f} ms, device busy "
            f"{block['device_busy_ms']:.3f} ms ({block['busy_share']:.1%}), "
            f"{block['kernel_launches_per_tick']:.2f} kernel launches a tick (the port's {block['port_launches']}, "
            f"== the profiler's record; {block['warmup_marks_recorded']} of {WARMUP_MARKS} marks recorded); "
            f"kernel ms by phase "
            f"{block['phases_kernel_ms']}; span ms by phase {block['phases_span_ms']}; this port's kernels "
            f"{block['port_kernels']}")
        for rec in block["top_kernels"]:
            log(f"phase9:   {rec['ms']:.4f} ms  x{rec['launches']}  {rec['name'][:110]}")
        checks.append(lifecycle_profile(dev, state, victims, faults))
    buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    plain_ms = time_ms(lambda: lifecycle_kernel.first_live_learner_plain(*plain_inputs), 3, buf)
    split = {}
    for name, recs in (("fired", [r for r in learner if r["fired"]]),
                       ("empty", [r for r in learner if not r["fired"]])):
        split[name] = {"launches": len(recs), "mean_ms": statistics.fmean(r["ms"] for r in recs) if recs else None,
                       "mean_bound_ms": statistics.fmean(r["bound_ms"] for r in recs) if recs else None}
    in_tick = {
        "launches": len(learner), "ticks_fired": sum(r["fired"] for r in learner),
        "mean_ms": statistics.fmean(r["ms"] for r in learner), "mean_bound_ms": statistics.fmean(
            r["bound_ms"] for r in learner), "by_want": split, "plain_ms": plain_ms,
        "plain_inputs_fired": bool(plain_inputs[3].any()),
    }
    log(f"phase9: L2 in the tick: {in_tick['launches']} launches timed, a timer fired in "
        f"{in_tick['ticks_fired']} ticks; mean {in_tick['mean_ms'] * 1e3:.2f} us a launch (bound "
        f"{in_tick['mean_bound_ms'] * 1e3:.2f} us); by want {split}; plain {plain_ms:.3f} ms on a "
        f"{'fired' if in_tick['plain_inputs_fired'] else 'quiet'} tick's inputs; every launch == plain")
    per_tick = [block["kernel_launches_per_tick"] for block in blocks]
    check(all(x <= LIFE_LAUNCHES_A_TICK_MAX for x in per_tick),
          f"launches a tick in every block {per_tick} <= {LIFE_LAUNCHES_A_TICK_MAX}")
    return {"blocks": blocks, "checks": checks, "learner_in_tick": in_tick}


def phase9_lifecycle_headline(dev: torch.device) -> dict:
    """bench.py's headline at 1,000,000 x 256: kernels vs plain for the
    first ticks and the kernels' profile on the state they reach, then the
    counted, timed detection + convergence + view checksum run against the
    JAX pins, then the same ticks again under the profiler with L1 and L2
    alone at each detection check."""
    n, k = LIFE_N, LIFE_K
    victims, faults = headline_faults(dev, n)
    params = lifecycle.LifecycleParams(n=n, k=k, rng="counter", exchange="shift")
    subjects = torch.as_tensor(victims, dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    a = lifecycle.init_state(params, seed=LIFE_SEED, device=dev)
    b = a
    for t in range(LIFE_TWIN_TICKS):
        a = lifecycle.step(params, a, faults)
        qa = (lifecycle.detection_complete(a, subjects, faults), lifecycle.view_checksums(a, faults))
        before = {**packbits_kernel.launches, **lifecycle_kernel.launches}
        with plain_lifecycle():
            b = lifecycle.step(params, b, faults)
            qb = (lifecycle.detection_complete(b, subjects, faults), lifecycle.view_checksums(b, faults))
        check({**packbits_kernel.launches, **lifecycle_kernel.launches} == before,
              "the plain twin launched no kernel")
        for name, x, y in zip(lifecycle.LifecycleState._fields, a, b):
            check(torch.equal(x, y), f"tick {t + 1}: {name} on the kernels == on the plain versions")
        check(torch.equal(qa[0], qb[0]) and torch.equal(qa[1], qb[1]),
              f"tick {t + 1}: detection_complete and view_checksums on the kernels == plain")
    digests = leaf_digests(lifecycle.state_to_numpy(a), lifecycle.LifecycleState._fields)
    for name, want in PIN_LIFE_TWIN.items():
        check(digests[name] == want, f"tick {LIFE_TWIN_TICKS}: {name} digest == the JAX package's")
    torch.cuda.synchronize()
    log(f"phase9: {LIFE_TWIN_TICKS} ticks at {n} x {k}: every leaf, detection_complete and view_checksums "
        f"on the kernels == on the plain versions at every tick; tick-{LIFE_TWIN_TICKS} digests == JAX "
        f"({time.perf_counter() - t0:.1f} s with the warm-up)")
    # the kernels alone on a state in mid-detection (its slots in flight)
    prof = lifecycle_profile(dev, a, victims, faults)
    del a, b, qa, qb

    # -- the main path: launch counts are 0 before it and read right after --
    runs = []
    for run_i in range(LIFE_RUNS):
        sim = lifecycle.LifecycleSim(n=n, k=k, seed=LIFE_SEED, rng="counter", device=dev)
        torch.cuda.synchronize()
        if run_i == 0:
            packbits_kernel.reset_launches()
            lifecycle_kernel.reset_launches()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        events[0].record()
        ticks, ok = sim.run_until_detected(victims, faults, max_ticks=LIFE_MAX_TICKS,
                                           check_every=LIFE_CHECK_EVERY, blocks_per_dispatch=8)
        events[1].record()
        cticks, cok = sim.run_until_converged(faults, max_ticks=LIFE_MAX_TICKS,
                                              check_every=LIFE_CHECK_EVERY, blocks_per_dispatch=8)
        events[2].record()
        cs = lifecycle.view_checksums(sim.state, faults)
        events[3].record()
        torch.cuda.synchronize()
        detect_ms, converge_ms, views_ms = (events[i].elapsed_time(events[i + 1]) for i in range(3))
        runs.append({"detect_ms": detect_ms, "converge_ms": converge_ms, "view_checksums_ms": views_ms})
        if run_i == 0:
            launches = port_launches()
            final, final_cs = sim.state, cs
            check(ok and ticks == PIN_LIFE_DETECT_TICKS,
                  f"detected in {ticks} ticks (JAX: {PIN_LIFE_DETECT_TICKS})")
            check(cok and cticks == PIN_LIFE_CONVERGE_TICKS,
                  f"converged {cticks} ticks later (JAX: {PIN_LIFE_CONVERGE_TICKS})")
        del sim
    digests = leaf_digests(lifecycle.state_to_numpy(final), lifecycle.LifecycleState._fields)
    for name, want in PIN_LIFE.items():
        check(digests[name] == want, f"final {name} digest == the JAX package's")
    cs_np = final_cs.cpu().numpy()
    check(final_cs.dtype == torch.int64 and cs_np.shape == (n,) and cs_np.min() >= 0 and cs_np.max() < 2**32,
          "view_checksums is int64[N] holding uint32")
    cs_sum = int(cs_np.sum()) % 2**32
    cs_sha = hashlib.sha256(cs_np.astype("<u4").tobytes()).hexdigest()
    check(cs_sum == PIN_LIFE_VIEWS_SUM and cs_sha == PIN_LIFE_VIEWS_SHA,
          f"view_checksums: sum {cs_sum} and digest == the JAX package's")
    checks = 1 + PIN_LIFE_DETECT_TICKS // LIFE_CHECK_EVERY
    want_launches = {"row_reduce": 3 * PIN_LIFE_DETECT_TICKS, "popcount_rows": 0,
                     "slot_walk": checks + 2, "first_live_learner": PIN_LIFE_DETECT_TICKS,
                     **{f"threefry_{name}": 0 for name in threefry_kernel.launches}}
    check(launches == want_launches,
          f"the lifecycle path launched S1 3x a tick, L2 once a tick, L1 once a check + 2 (and no T1 on the "
          f"counter stream): {launches}")
    log(f"phase9: detected in {ticks} ticks == JAX, converged {cticks} ticks later == JAX; final leaf "
        f"digests and view_checksums (sum {cs_sum}) == JAX; launches {launches}; "
        f"runs {runs}")
    del final, final_cs
    trace = lifecycle_trace(dev, params, faults, victims)
    return {
        "launches": launches, "detect_ticks": ticks, "converge_ticks": cticks,
        "runs": runs, "detect_ms_per_tick": [r["detect_ms"] / ticks for r in runs],
        "view_checksums_sum": cs_sum, "kernel_profile": prof, **trace,
    }


def detect_wall(dev: torch.device, rng: str = "counter", runs: int = 5) -> list[float]:
    """The headline's ``run_until_detected`` at stream ``rng`` alone,
    ``runs`` times after one untimed run (CUDA events, ms, the pinned tick
    count checked): the detection wall without the rest of the script, so
    that two checkouts can be compared on one card in one call."""
    pin = {"counter": PIN_LIFE_DETECT_TICKS, "threefry": PIN_TF_LIFE_DETECT_TICKS}[rng]
    victims, faults = headline_faults(dev, LIFE_N)
    walls = []
    for _ in range(runs + 1):
        sim = lifecycle.LifecycleSim(n=LIFE_N, k=LIFE_K, seed=LIFE_SEED, rng=rng, device=dev)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ticks, ok = sim.run_until_detected(victims, faults, max_ticks=LIFE_MAX_TICKS,
                                           check_every=LIFE_CHECK_EVERY, blocks_per_dispatch=8)
        end.record()
        torch.cuda.synchronize()
        check(ok and ticks == pin, f"{rng}: detected in {ticks} ticks (JAX: {pin})")
        walls.append(start.elapsed_time(end))
        del sim
    return walls[1:]


def run_lifecycle(dev: torch.device) -> tuple[list, dict]:
    """Phases 8-9 on ``dev``; returns L1's and L2's records, the lifecycle
    path's S1/S2 launches and the timings."""
    max_err = phase8_lifecycle_kernels(dev)
    life = phase9_lifecycle_headline(dev)
    launches = life["launches"]
    full = life["checks"][1]  # tick 64: a full slot table, the detection checks' common case
    walk = full["slot_walk_detect"]
    by_case = {f"tick{c['tick']}_{mode}": c[f"slot_walk_{mode}"] for c in life["checks"] for mode in
               ("detect", "checksum")}
    by_case.update({f"tick{LIFE_TWIN_TICKS}_{mode}": life["kernel_profile"][f"slot_walk_{mode}"]
                    for mode in ("detect", "checksum")})
    in_tick = life["learner_in_tick"]
    kernels = [{
        "name": "lifecycle_slot_walk", "route": "cuda", "source": "ringpop_tpu_torch/csrc/lifecycle.cu",
        "replaces": "ringpop_tpu/sim/lifecycle.py:1363", "launches": launches["slot_walk"],
        "max_abs_err": max_err,
        "state": f"tick {full['tick']}, detect mode", "ms": walk["kernel_ms"], "call_ms": walk["call_ms"],
        "plain_ms": walk["plain_ms"], "bound_ms": walk["bound_ms"], "share_of_bound": walk["share_of_bound"],
        "bound_by": "bytes", "library_ms": None, "by_case": by_case,
    }, {
        "name": "lifecycle_first_live_learner", "route": "cuda", "source": "ringpop_tpu_torch/csrc/lifecycle.cu",
        "replaces": "ringpop_tpu/sim/lifecycle.py:755", "launches": launches["first_live_learner"],
        "max_abs_err": max_err, "state": "in the tick, mean over the main path's launches",
        "ms": in_tick["mean_ms"], "plain_ms": in_tick["plain_ms"], "bound_ms": in_tick["mean_bound_ms"],
        "share_of_bound": in_tick["mean_bound_ms"] / in_tick["mean_ms"], "bound_by": "bytes",
        "library_ms": None, "in_tick": in_tick,
        "by_case": {f"tick{c['tick']}_want_none": c["first_live_learner"]
                    for c in [life["kernel_profile"], *life["checks"]]},
    }]
    return kernels, {"lifecycle": life}


# -- the threefry stream: kernel T1, and bench.py's record on its own stream --


@contextlib.contextmanager
def plain_threefry():
    """Route ``sim/threefry``'s draws on CUDA keys to their plain versions (on
    the card) for the duration: the threefry stream with no T1 launch."""
    names = ("split_cuda", "bits_cuda", "randint_cuda", "uniform_cuda")
    saved = [getattr(threefry_kernel, name) for name in names]
    plain = (threefry.split_plain, threefry.random_bits32_plain, threefry.randint_plain, threefry.uniform_plain)
    for name, fn in zip(names, plain):
        setattr(threefry_kernel, name, fn)
    try:
        yield
    finally:
        for name, fn in zip(names, saved):
            setattr(threefry_kernel, name, fn)


def t1_keys(dev: torch.device) -> dict[str, torch.Tensor]:
    """Raw keys on the card: ``PRNGKey`` of several seeds, and keys three
    splits deep from each (the engines split keys that came from splits)."""
    keys = {}
    for seed in TF_SEEDS:
        key = prng.prng_key(seed, dev)
        keys[f"seed {seed}"] = key
        for depth in range(1, 4):
            key = threefry.split_plain(key, 5)[depth]
            keys[f"seed {seed}, split depth {depth}"] = key
    return keys


def check_t1(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """One T1 launch == its plain version, bit for bit; returns the max abs
    difference."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"T1 {what}: {got.dtype}{list(got.shape)} vs plain {want.dtype}{list(want.shape)}")
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    check(torch.equal(got, want), f"T1 == plain ({what})")
    return err


def phase10_threefry(dev: torch.device) -> float:
    """T1 (split, randint, uniform, bits) bit-equal to its plain version on
    the card: keys of several seeds and chained splits; shapes (), (1,),
    (n,) and (n, 3) at n = 1,000,000; the spans of TF_SPANS; every kernel at
    the ragged counts of TF_TAILS; and two draws of more than 2**32 values,
    one at a two-stream span (1000) and one at a one-stream span (n), each
    head against the plain draw and the elements around 2**32 and the tail
    against the plain threefry2x32 on explicit (hi, lo) counters.  Returns
    the max abs difference."""
    n = TF_N
    t0 = time.perf_counter()
    threefry_kernel.reset_launches()
    calls = dict.fromkeys(threefry_kernel.launches, 0)
    spans = TF_SPANS
    variants = {threefry_kernel.randint_variant(lo, hi)[2:] for lo, hi in spans}
    check(len({(two, rec[1]) for two, rec in variants}) == 4, f"TF_SPANS reach the four randint variants: {variants}")
    err = 0.0
    for what, key in t1_keys(dev).items():
        for num in (2, 3, 5):
            err = max(err, check_t1(threefry_kernel.split_cuda(key, num), threefry.split_plain(key, num),
                                    f"split {num}, {what}"))
            calls["split"] += 1
        for shape in ((), (1,), (n,), (n, 3)):
            for lo, hi in spans:
                err = max(err, check_t1(threefry_kernel.randint_cuda(key, shape, lo, hi),
                                        threefry.randint_plain(key, shape, lo, hi),
                                        f"randint {shape} [{lo}, {hi}), {what}"))
                calls["randint"] += 1
            err = max(err, check_t1(threefry_kernel.uniform_cuda(key, shape), threefry.uniform_plain(key, shape),
                                    f"uniform {shape}, {what}"))
            err = max(err, check_t1(threefry_kernel.bits_cuda(key, shape), threefry.random_bits32_plain(key, shape),
                                    f"bits {shape}, {what}"))
            calls["uniform"] += 1
            calls["bits"] += 1
    log(f"phase10: split (2, 3, 5), randint ({len(spans)} spans), uniform and bits at (), (1,), ({n},), ({n}, 3) "
        f"over {len(t1_keys(dev))} keys: T1 == plain (tolerance: none, bit-equal; {time.perf_counter() - t0:.1f} s)")

    # ragged tails: T1 writes a thread's run of 8 with vector stores, a tail element by element
    for seed in TF_SEEDS:
        key = prng.prng_key(seed, dev)
        for count in TF_TAILS:
            shape = (count,)
            err = max(err, check_t1(threefry_kernel.split_cuda(key, count), threefry.split_plain(key, count),
                                    f"split {count}, seed {seed}"))
            err = max(err, check_t1(threefry_kernel.bits_cuda(key, shape), threefry.random_bits32_plain(key, shape),
                                    f"bits {shape}, seed {seed}"))
            err = max(err, check_t1(threefry_kernel.uniform_cuda(key, shape), threefry.uniform_plain(key, shape),
                                    f"uniform {shape}, seed {seed}"))
            for lo, hi in ((0, n), (0, 1000), (0, 7), (0, 2**31 - 1)):
                err = max(err, check_t1(threefry_kernel.randint_cuda(key, shape, lo, hi),
                                        threefry.randint_plain(key, shape, lo, hi),
                                        f"randint {shape} [{lo}, {hi}), seed {seed}"))
            calls["split"] += 1
            calls["bits"] += 1
            calls["uniform"] += 1
            calls["randint"] += 4
    log(f"phase10: every kernel at the ragged counts {TF_TAILS} over {len(TF_SEEDS)} keys: T1 == plain "
        f"({time.perf_counter() - t0:.1f} s)")

    # counters past 2**32: the high word is 1 for the last 2**20 outputs
    key = prng.prng_key(SEED, dev)
    ka, kb = threefry.split_plain(key, 2)
    for hi in (1000, n):  # two streams, one stream
        big = threefry_kernel.randint_cuda(key, (TF_BIG,), 0, hi)
        calls["randint"] += 1
        err = max(err, check_t1(big[:n], threefry.randint_plain(key, (n,), 0, hi), f"randint ({TF_BIG},) [0, {hi}) head"))
        for lo_i, hi_i in (((1 << 32) - 4096, (1 << 32) + 4096), (TF_BIG - 4096, TF_BIG)):
            idx = torch.arange(lo_i, hi_i, dtype=torch.int64, device=dev)
            c_hi, c_lo = idx >> 32, idx & 0xFFFF_FFFF
            h1, h2 = threefry.threefry2x32(ka[0], ka[1], c_hi, c_lo)
            l1, l2 = threefry.threefry2x32(kb[0], kb[1], c_hi, c_lo)
            want = threefry.randint_from_bits(h1 ^ h2, l1 ^ l2, 0, hi)
            err = max(err, check_t1(big[lo_i:hi_i], want, f"randint ({TF_BIG},) [0, {hi}) elements [{lo_i}, {hi_i})"))
        del big
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    check(threefry_kernel.launches == calls, f"one launch per wrapper call: {threefry_kernel.launches} vs {calls}")
    log(f"phase10: two draws of {TF_BIG} int32 values (counters past 2**32), spans 1000 and {n}: heads, the elements "
        f"around 2**32 and the tails == plain threefry2x32 on explicit (hi, lo) counters; launches "
        f"{threefry_kernel.launches}; max abs err {err} ({time.perf_counter() - t0:.1f} s)")
    return err


def t1_kernel_of(symbol: str) -> str | None:
    """The T1_KERNELS name of a mangled kernel symbol, randint's by its
    instantiation (T1_RANDINT_VARIANTS); None for another kernel."""
    name = next((name for name, kname in T1_KERNELS.items() if kname in symbol), None)
    if name == "randint":
        name = next((v for v, args in T1_RANDINT_VARIANTS.items() if args in symbol), name)
    return name


def ptxas_registers(lib: Path, name_of) -> dict[str, int]:
    """Registers a thread of each kernel of the built library ``lib``, from
    its ptxas report (``lib``'s ``.log``), under ``name_of(mangled
    symbol)``; kernels it names None are left out."""
    regs, cur = {}, None
    for line in lib.with_suffix(".log").read_text().splitlines():
        fn = re.search(r"Compiling entry function '(\S+)'", line)
        if fn:
            cur = name_of(fn.group(1))
        used = re.search(r"Used (\d+) registers", line)
        if cur and used:
            regs[cur] = int(used.group(1))
    return regs


def sass_opcodes(lib: Path, name_of) -> dict[str, dict[str, int]]:
    """The SASS opcodes (NOPs left out) of each kernel of the library
    ``lib``, from ``cuobjdump -sass``, most frequent first, under
    ``name_of(mangled symbol)``; kernels it names None are left out."""
    tool = Path(_cuda_build.find_nvcc()).with_name("cuobjdump")
    proc = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0, f"cuobjdump -sass {lib.name}: {proc.stderr[-500:]}")
    mix, cur = {}, None
    for line in proc.stdout.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            cur = name_of(fn.group(1))
            if cur:
                mix[cur] = {}
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+([^;]*);", line)
        if cur and ins:
            words = ins.group(1).split()
            op = words[1] if words[0].startswith("@") else words[0]  # past a predicate
            if op != "NOP":
                mix[cur][op] = mix[cur].get(op, 0) + 1
    return {name: dict(sorted(ops.items(), key=lambda kv: -kv[1])) for name, ops in mix.items()}


def t1_sass_counts(lib: Path) -> dict[str, int]:
    """Instructions (NOPs left out) of each T1 kernel in the library
    ``lib``, from ``cuobjdump -sass``, by t1_kernel_of's names."""
    counts = {name: sum(ops.values()) for name, ops in sass_opcodes(lib, t1_kernel_of).items()}
    want = {"split", "bits", "uniform", *T1_RANDINT_VARIANTS}
    check(set(counts) == want and all(counts.values()), f"SASS of every T1 kernel and randint variant: {counts}")
    return counts


def t1_per_thread() -> int:
    """The elements a T1 thread draws (``RP_THREEFRY_PER_THREAD`` in its
    source)."""
    found = re.search(r"#define RP_THREEFRY_PER_THREAD (\d+)", threefry_kernel.SOURCE.read_text())
    check(found is not None, "RP_THREEFRY_PER_THREAD in csrc/threefry.cu")
    return int(found.group(1))


def t1_sass_per_element() -> tuple[dict[str, float], dict]:
    """Each T1 kernel's SASS instructions an element, as the difference
    between the built library (kPerThread elements a thread) and a build of
    half as many, over the elements between: what one more element of a
    run executes, without the thread's own work or the ragged tail's
    element.  Returns it and the two builds' counts."""
    per_thread = t1_per_thread()
    half = per_thread // 2
    check(half % 4 == 0, f"a build of {half} elements a thread stores runs of four")
    full = t1_sass_counts(threefry_kernel.build())
    halved = t1_sass_counts(threefry_kernel.build((f"RP_THREEFRY_PER_THREAD={half}",)))
    return ({name: (full[name] - halved[name]) / (per_thread - half) for name in full},
            {per_thread: full, half: halved})


def instruction_rate(dev: torch.device) -> tuple[float, float]:
    """(the lane instructions the card can dispatch a second at its maximum SM
    clock, that clock in MHz): DISPATCH_LANES_PER_SM x SMs x clock."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi clocks.max.sm: {smi.stderr[-200:]}")
    mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return DISPATCH_LANES_PER_SM * sms * mhz * 1e6, mhz


def t1_profile(dev: torch.device) -> dict:
    """T1 alone (profiler, by name, after a flush that leaves the L2 cache
    clean) at each shape the main path draws, and at a two-stream span, the
    wrapper call and the plain version (CUDA events), beside the bound: the
    larger of the bytes (the key read, the output written) over 3.35 TB/s
    and the function's instructions (T1_OPS an element) over the card's
    instruction rate.  T1_OPS comes from the function's definition, not
    from the kernel measured; each count is held to no more than its
    kernel's SASS an element (t1_sass_per_element), and the cipher's to the
    ``bits`` kernel's, so no share reads over 100 %.  The first design's
    SASS yardstick (SASS_YARDSTICK_RANDINT_OPS) is logged beside."""
    per_element, sass = t1_sass_per_element()
    check(THREEFRY2X32_OPS + XOR_OPS <= per_element["bits"] and REMAINDER_OPS <= per_element["bits"],
          f"the function's counts {T1_OPS} are no more than the bits kernel's SASS an element {per_element}")
    for name, ops in T1_OPS.items():
        check(ops <= per_element[name], f"T1_OPS[{name}] {ops} <= its kernel's SASS an element {per_element}")
    rate, mhz = instruction_rate(dev)
    n = TF_N
    key = prng.prng_key(LIFE_SEED, dev)
    buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    clean = lambda: buf.sum(dtype=torch.int64)  # noqa: E731
    cases = {  # name: (kernel, draw arguments, elements, output bytes an element)
        "randint_n_by_3": ("randint", ((n, 3), 0, n), 3 * n, 4),  # the lifecycle's ping-req peers
        "randint_n": ("randint", ((n,), 0, n - 1), n, 4),  # the uniform exchange's targets
        "uniform_n": ("uniform", ((n,),), n, 4),  # the drop coin
        "randint_scalar": ("randint", ((), 1, n), 1, 4),  # the shift, the healer's pair
        "uniform_scalar": ("uniform", ((),), 1, 4),  # the healer's coin
        "split_5": ("split", (5,), 5, 16),  # the tick's keys
        "randint_n_span_1000": ("randint", ((n,), 0, 1000), n, 4),  # two streams: no main-path draw
    }
    launcher = {"split": threefry_kernel.split_cuda, "randint": threefry_kernel.randint_cuda,
                "uniform": threefry_kernel.uniform_cuda}
    plain = {"split": threefry.split_plain, "randint": threefry.randint_plain, "uniform": threefry.uniform_plain}
    out = {"sass_instructions": sass, "sass_per_element": per_element, "least_ops_per_element": T1_OPS,
           "instruction_rate": rate, "max_sm_clock_mhz": mhz}
    for name, (kind, args, elements, width) in cases.items():
        ops_kind = kind
        if kind == "randint":
            _, _, two_streams, (_, add, _, _) = threefry_kernel.randint_variant(*args[1:])
            check(not add, f"{name}: the span's reciprocal is a 32-bit magic (REMAINDER_OPS)")
            ops_kind = "randint_two_streams" if two_streams else "randint_one_stream"
        fn = lambda: launcher[kind](key, *args)  # noqa: E731
        ref = lambda: plain[kind](key, *args)  # noqa: E731
        check(torch.equal(fn(), ref()), f"T1 {name} == plain")
        ms = one_kernel_ms(profile_ms(fn, 20, clean, "reduce_kernel"), T1_KERNELS[kind])
        nbytes = 16 + elements * width
        ops = elements * T1_OPS[ops_kind]
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        rec = out[name] = {
            "kernel_ms": ms, "call_ms": time_ms(fn, 20, buf), "plain_ms": time_ms(ref, 5, buf),
            "bound_ms": bound_ms, "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bytes_ms": bytes_ms, "operations_ms": ops_ms, "bytes": nbytes, "operations": ops,
            "variant": ops_kind, "share_of_bound": bound_ms / ms,
        }
        yardstick = ""
        if ops_kind == "randint_one_stream" and elements > 1:
            old_ms = max(bytes_ms, elements * SASS_YARDSTICK_RANDINT_OPS / rate * 1e3)
            yardstick = (f"; the first design's SASS yardstick ({SASS_YARDSTICK_RANDINT_OPS} an element) "
                         f"{old_ms * 1e3:.2f} us, {old_ms / ms:.1%}")
        log(f"profile: T1 {name} ({ops_kind}): kernel alone {ms * 1e3:.2f} us after a clean flush; call "
            f"{rec['call_ms'] * 1e3:.2f} us; plain {rec['plain_ms']:.4f} ms; bound {bound_ms * 1e3:.2f} us "
            f"({rec['bound_by']}: {nbytes} bytes {bytes_ms * 1e3:.2f} us, {ops} instructions ({T1_OPS[ops_kind]} an "
            f"element) {ops_ms * 1e3:.2f} us; {rec['share_of_bound']:.1%}){yardstick}")
    log(f"profile: T1 SASS instructions a thread by elements a thread {sass}: {per_element} an element; the "
        f"function's {T1_OPS} an element; instruction rate {rate:.4g} lane instructions/s at {mhz:.0f} MHz")
    return out


def interleaved_detect(dev: torch.device, victims, faults) -> dict[str, list[float]]:
    """The headline's ``run_until_detected`` at both streams in turns
    (counter, threefry, threefry, counter; CUDA events, ms), each held to
    its pinned tick count."""
    walls = {"counter": [], "threefry": []}
    pins = {"counter": PIN_LIFE_DETECT_TICKS, "threefry": PIN_TF_LIFE_DETECT_TICKS}
    for rng in ("counter", "threefry", "threefry", "counter"):
        sim = lifecycle.LifecycleSim(n=LIFE_N, k=LIFE_K, seed=LIFE_SEED, rng=rng, device=dev)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ticks, ok = sim.run_until_detected(victims, faults, max_ticks=LIFE_MAX_TICKS,
                                           check_every=LIFE_CHECK_EVERY, blocks_per_dispatch=8)
        end.record()
        torch.cuda.synchronize()
        check(ok and ticks == pins[rng], f"{rng}: detected in {ticks} ticks (JAX: {pins[rng]})")
        walls[rng].append(start.elapsed_time(end))
        del sim
    return walls


def phase11_bench_twin(dev: torch.device) -> dict:
    """bench.py's record on its own stream: the headline's first ticks with
    T1 and with its plain version, the twin (``bench.run_bench``) at full
    scale against the JAX threefry pins with its launch counts, the uniform
    exchange with faults at threefry, a 32-tick block at each stream under
    the profiler, and detection at both streams in turns."""
    n, k = LIFE_N, LIFE_K
    victims, faults = headline_faults(dev, n)
    params = lifecycle.LifecycleParams(n=n, k=k)
    check(params.rng == "threefry" and params.exchange == "shift", "the engines' default is bench.py's stream")
    t0 = time.perf_counter()
    a = lifecycle.init_state(params, seed=LIFE_SEED, device=dev)
    b = a
    for t in range(LIFE_TWIN_TICKS):
        a = lifecycle.step(params, a, faults)
        before = dict(threefry_kernel.launches)
        with plain_threefry():
            b = lifecycle.step(params, b, faults)
        check(threefry_kernel.launches == before, "the plain twin launched no T1")
        for name, x, y in zip(lifecycle.LifecycleState._fields, a, b):
            check(torch.equal(x, y), f"threefry tick {t + 1}: {name} with T1 == with the plain draws")
    digests = leaf_digests(lifecycle.state_to_numpy(a), lifecycle.LifecycleState._fields)
    for name, want in PIN_TF_LIFE_TWIN.items():
        check(digests[name] == want, f"threefry tick {LIFE_TWIN_TICKS}: {name} digest == the JAX package's")
    del a, b
    log(f"phase11: {LIFE_TWIN_TICKS} threefry ticks at {n} x {k}: every leaf with T1 == with the plain draws "
        f"at every tick; tick-{LIFE_TWIN_TICKS} digests == JAX ({time.perf_counter() - t0:.1f} s)")

    # -- the main path: the bench twin; launch counts are 0 before it and read right after --
    bench.reset_launch_counts()
    t0 = time.perf_counter()
    record = bench.run_bench(dev, "threefry", fast=False, runs=LIFE_RUNS)
    launches = port_launches()
    wall_s = time.perf_counter() - t0
    log(f"phase11: bench twin record {json.dumps(record)}")
    check(record["detected"] and record["ticks"] == PIN_TF_LIFE_DETECT_TICKS,
          f"twin detected in {record['ticks']} ticks (JAX: {PIN_TF_LIFE_DETECT_TICKS})")
    check(record["converged"] and record["converge_extra_ticks"] == PIN_TF_LIFE_CONVERGE_TICKS,
          f"twin converged {record['converge_extra_ticks']} ticks later (JAX: {PIN_TF_LIFE_CONVERGE_TICKS})")
    check(record["view_checksum_sum"] == PIN_TF_LIFE_VIEWS_SUM and record["view_checksum_sha256"] ==
          PIN_TF_LIFE_VIEWS_SHA, f"twin view_checksums: sum {record['view_checksum_sum']} and digest == JAX")
    check(record["lifecycle_final_digests"] == PIN_TF_LIFE, "twin lifecycle final leaf digests == JAX")
    check(record["delta_converged"] and record["delta_ticks"] == PIN_TF_DELTA_TICKS,
          f"twin delta converged in {record['delta_ticks']} ticks (JAX: {PIN_TF_DELTA_TICKS})")
    check(record["delta_final_digests"] == PIN_TF_DELTA, "twin delta final leaf digests == JAX")
    check(record["rng"] == "threefry" and record["platform"] == "cuda" and len(record["detect_s_runs"]) == LIFE_RUNS,
          "the record names its stream, platform and every timed run")
    # each timed run detects from a fresh state, the convergence leg runs once,
    # after the last, and each engine's warm-up steps one tick
    life_ticks = LIFE_RUNS * PIN_TF_LIFE_DETECT_TICKS + PIN_TF_LIFE_CONVERGE_TICKS + 1
    dticks = LIFE_RUNS * PIN_TF_DELTA_TICKS + 1
    want_t1 = {"threefry_split": 3 * life_ticks + dticks, "threefry_bits": 0,
               "threefry_randint": 4 * life_ticks + dticks, "threefry_uniform": life_ticks}
    check({name: launches[name] for name in want_t1} == want_t1,
          f"T1 once a draw: a lifecycle tick 3 splits, 4 randints, 1 uniform; a delta tick 1 split, 1 randint "
          f"({LIFE_RUNS} runs): {launches}")
    check(all(launches[name] > 0 for name in ("row_reduce", "slot_walk", "first_live_learner")),
          f"the twin's legs launched S1, L1 and L2: {launches}")
    log(f"phase11: the twin matched the JAX threefry pins (detection {record['ticks']} ticks, converged "
        f"{record['converge_extra_ticks']} later, checksum sum {record['view_checksum_sum']}, delta "
        f"{record['delta_ticks']} ticks, final digests); launches {launches}; {wall_s:.1f} s")

    # -- phase 7's configuration at threefry: the uniform targets and the drop coin --
    dparams = delta.DeltaParams(n=DELTA_N, k=DELTA_K, exchange="uniform")
    up = np.ones(DELTA_N, bool)
    up[uniform_down_nodes(DELTA_N)] = False
    dfaults = delta.DeltaFaults(up=torch.from_numpy(up).to(dev),
                                drop_rate=torch.tensor(UNIFORM_DROP, dtype=torch.float32, device=dev))
    state = delta.init_state(dparams, seed=DELTA_SEED, device=dev)
    before = dict(threefry_kernel.launches)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(UNIFORM_TICKS):
        state = delta.step(dparams, state, dfaults)
    end.record()
    torch.cuda.synchronize()
    uniform_ms = start.elapsed_time(end)
    digests = leaf_digests(delta.state_to_numpy(state))
    for name, want in PIN_TF_UNIFORM.items():
        check(digests[name] == want, f"threefry uniform: final {name} digest == the JAX package's")
    drawn = {name: threefry_kernel.launches[name] - before[name] for name in before}
    check(drawn == {"split": UNIFORM_TICKS, "bits": 0, "randint": UNIFORM_TICKS, "uniform": UNIFORM_TICKS,
                    "fold_in": 0, "categorical": 0},
          f"the uniform exchange drew targets and the drop coin through T1 once a tick: {drawn}")
    log(f"phase11: uniform, {UNIFORM_DOWN} down, drop {UNIFORM_DROP}, threefry: {UNIFORM_TICKS} ticks in "
        f"{uniform_ms:.3f} ms; final leaf digests == JAX; T1 {drawn}")
    del state

    # -- launches a tick and the busy share at both streams, then detection in turns --
    blocks = {}
    for rng in ("counter", "threefry"):
        p = lifecycle.LifecycleParams(n=n, k=k, rng=rng)
        _, block = lifecycle_block_profile(p, lifecycle.init_state(p, seed=LIFE_SEED, device=dev), faults,
                                           LIFE_CHECK_EVERY)
        block.pop("learner_calls")
        block.pop("learner_ms")
        blocks[rng] = block
        log(f"phase11: {rng}, ticks 1-{LIFE_CHECK_EVERY} under the profiler: window {block['window_ms']:.3f} ms, "
            f"device busy {block['device_busy_ms']:.3f} ms ({block['busy_share']:.1%}), "
            f"{block['kernel_launches_per_tick']:.2f} kernel launches a tick (the port's {block['port_launches']}); "
            f"kernel ms by phase {block['phases_kernel_ms']}")
    walls = interleaved_detect(dev, victims, faults)
    log(f"phase11: detection in turns (counter, threefry, threefry, counter), ms: {walls}; ms a tick: counter "
        f"{[w / PIN_LIFE_DETECT_TICKS for w in walls['counter']]}, threefry "
        f"{[w / PIN_TF_LIFE_DETECT_TICKS for w in walls['threefry']]}")
    return {"record": record, "launches": launches, "twin_wall_s": wall_s,
            "uniform_threefry": {"ticks": UNIFORM_TICKS, "wall_ms": uniform_ms, "ms_per_tick": uniform_ms / UNIFORM_TICKS},
            "blocks": blocks, "detect_ms_in_turns": walls}


def run_threefry(dev: torch.device) -> tuple[list, dict]:
    """Phases 10-11 on ``dev``; returns T1's record and the timings."""
    max_err = phase10_threefry(dev)
    prof = t1_profile(dev)
    twin = phase11_bench_twin(dev)
    main = prof["randint_n_by_3"]
    t1_launches = {name: twin["launches"][f"threefry_{name}"] for name in T1_KERNELS}
    measured = ("kernel_ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound", "variant")
    kernels = [{
        "name": "threefry", "route": "cuda", "source": "ringpop_tpu_torch/csrc/threefry.cu",
        "replaces": "ringpop_tpu/sim/lifecycle.py:446 (jax.random split/randint/uniform at the engines' draw "
                    "sites, lowered by XLA's _threefry2x32_lowering; no Pallas kernel)",
        "launches": sum(t1_launches.values()), "launches_by_kernel": t1_launches, "max_abs_err": max_err,
        "state": "randint (1000000, 3), the lifecycle's ping-req peers", "ms": main["kernel_ms"],
        "call_ms": main["call_ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "share_of_bound": main["share_of_bound"], "bound_by": main["bound_by"], "library_ms": None,
        "library": "none: torch.randint (Philox) computes a different function",
        "by_case": {name: {k: rec[k] for k in measured} for name, rec in prof.items()
                    if isinstance(rec, dict) and "kernel_ms" in rec},
    }]
    return kernels, {"threefry": twin, "t1_profile": prof}


# -- the exact full-view engine: kernels C1 and F1, the lockstep gate, loss1k --

C1_F1_KERNELS = {"categorical": "threefry_categorical_kernel", "fold_in": "threefry_fold_in_kernel",
                 "apply": "fullview_apply_kernel"}
# the kernels of the fullview tick, by profiler name
FV_KERNELS = {**C1_F1_KERNELS, "split": "threefry_split_kernel", "uniform": "threefry_uniform_kernel"}


def fv_launches() -> dict[str, int]:
    """The launch counts of the fullview tick's kernels, by FV_KERNELS' names."""
    return {**{name: threefry_kernel.launches[name] for name in ("categorical", "fold_in", "split", "uniform")},
            "apply": fullview_kernel.launches["apply"]}


@contextlib.contextmanager
def plain_fullview():
    """Route C1 and F1 (and fold_in) on CUDA tensors to their plain versions
    (on the card) for the duration: the fullview tick without its kernels."""
    saved = threefry_kernel.categorical_cuda, threefry_kernel.fold_in_cuda, fullview_kernel.apply_cuda
    threefry_kernel.categorical_cuda = threefry.categorical_masked_plain
    threefry_kernel.fold_in_cuda = threefry.fold_in_plain
    fullview_kernel.apply_cuda = fullview_kernel.apply_plain
    try:
        yield
    finally:
        threefry_kernel.categorical_cuda, threefry_kernel.fold_in_cuda, fullview_kernel.apply_cuda = saved


@contextlib.contextmanager
def record_fullview_calls(calls: list):
    """Record (a copy of) the inputs of every C1 and F1 call for the
    duration, in call order: ("categorical", key, mask, reps) and ("apply",
    planes, cand_key, tick, now_ms, timeouts)."""
    c1, f1 = threefry_kernel.categorical_cuda, fullview_kernel.apply_cuda

    def categorical(key, mask, reps=None):
        calls.append(("categorical", key.clone(), mask.clone(), reps))
        return c1(key, mask, reps)

    def apply(planes, cand_key, tick, now_ms, timeouts):
        calls.append(("apply", [p.clone() for p in planes], cand_key.clone(), tick.clone(), now_ms.clone(), timeouts))
        return f1(planes, cand_key, tick, now_ms, timeouts)

    threefry_kernel.categorical_cuda, fullview_kernel.apply_cuda = categorical, apply
    try:
        yield
    finally:
        threefry_kernel.categorical_cuda, fullview_kernel.apply_cuda = c1, f1


def random_mask(gen: torch.Generator, rows: int, cols: int, density: float, dev) -> torch.Tensor:
    """A random bool mask whose rows 0-2, where it has them, allow nothing,
    everything and only the last entry."""
    m = torch.rand((rows, cols), generator=gen, device=dev) < density
    if rows >= 3:
        m[0] = False
        m[1] = True
        m[2] = False
        m[2, -1] = True
    return m


def random_fullview_batch(gen: torch.Generator, n: int, density: float, dev, tick: int = 37):
    """Seven random planes (every status, pending -1..4, deadlines around
    ``tick``, incarnations with ties, absent cells) and a candidate batch
    near each cell's own incarnation, so that wins, losses, ties,
    refutations and first-seen tombstones occur."""
    def ints(lo, hi, dtype):
        return torch.randint(lo, hi, (n, n), generator=gen, device=dev, dtype=torch.int64).to(dtype)

    inc = ints(0, 6, torch.int32) * 200
    planes = [ints(0, 5, torch.int8), inc, torch.rand((n, n), generator=gen, device=dev) < 0.7,
              torch.rand((n, n), generator=gen, device=dev) < 0.4, ints(0, 40, torch.int32), ints(-1, 5, torch.int8),
              ints(tick - 5, tick + 30, torch.int32)]
    cand_inc = (inc + ints(-1, 2, torch.int32) * 200).clamp_min(0)
    cand = torch.where(torch.rand((n, n), generator=gen, device=dev) < density,
                       (cand_inc << 3) | ints(0, 5, torch.int32), -1).to(torch.int32)
    return planes, cand


def c1_run() -> int:
    """The elements of one C1 run (``kRun`` in its source)."""
    found = re.search(r"constexpr int kRun = (\d+);", threefry_kernel.SOURCE.read_text())
    check(found is not None, "kRun in csrc/threefry.cu")
    return int(found.group(1))


def c1_crossing(gen: torch.Generator, key: torch.Tensor, rows: int, reps: int, cols: int, held) -> tuple[int, bool]:
    """One C1 draw of a random [rows, cols] mask with ``reps`` whose counters
    pass 2**32, held (``held``) at its first rows and the rows around the
    crossing against the plain version on explicit counters; the row before
    the crossing allows everything and the one before that nothing.
    Returns the crossing's row and whether the crossing falls inside one of
    C1's runs (which are aligned to the mask's address)."""
    dev = key.device
    mask = torch.empty((rows, cols), dtype=torch.bool, device=dev)
    step = max(1, (1 << 28) // cols)  # in slices: the float draw of the whole mask would take 4 bytes a cell
    for r0 in range(0, rows, step):
        mask[r0:r0 + step] = torch.rand((min(step, rows - r0), cols), generator=gen, device=dev) < 0.5
    crossing = (1 << 32) // cols  # the (row, rep) whose counters pass 2**32
    check(crossing // reps < rows, f"the {rows} x {reps} x {cols} draw passes 2**32")
    cross_row = crossing // reps
    mask[cross_row - 1] = True
    mask[cross_row - 2] = False
    got = threefry_kernel.categorical_cuda(key, mask, reps)
    check_rows = torch.tensor([0, 1, cross_row - 2, cross_row - 1, cross_row, rows - 1], device=dev)
    check_rows = torch.unique(check_rows.clamp_max(rows - 1))
    held("categorical", got[check_rows], threefry.categorical_masked_plain(key, mask, reps, rows=check_rows),
         f"{rows} x {reps} x {cols} at rows {check_rows.tolist()}")
    first_past = (1 << 32) - crossing * cols  # the column whose counter is 2**32
    mid_run = (mask.data_ptr() + cross_row * cols + first_past) % c1_run() != 0
    del mask, got
    return cross_row, mid_run


def phase12_fullview_kernels(dev: torch.device) -> dict:
    """C1, fold_in and F1 bit-equal to their plain versions on the card:
    C1 over masks at densities FV_DENSITIES (rows allowing nothing,
    everything and only the last entry) at N = FV_ROWS, reps None and 3,
    keys of three seeds and chained splits (every key below 4097 rows, the
    seeds' own above); draws of C1_BIG and C1_MIDRUN whose counters pass
    2**32 (C1_MIDRUN's inside a run), held at their first rows and the rows
    around the crossing against the plain version on explicit counters
    (:func:`c1_crossing`); long rows (FV_WIDE); masks whose base
    lies 1..7 bytes past alignment; fold_in at FV_FOLD_DATA; F1 on random
    states and candidate batches at N = FV_F1_ROWS and FV_BIG_N + 1, and
    its refusal of misaligned planes.  Returns each kernel's max abs
    difference and calls."""
    t0 = time.perf_counter()
    keys = t1_keys(dev)
    seed_keys = {name: k for name, k in keys.items() if "split" not in name}
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    err = {"categorical": 0, "fold_in": 0, "apply": 0}
    calls = dict.fromkeys(err, 0)

    def held(name, got, want, what):
        check(got.dtype == want.dtype and got.shape == want.shape, f"{name} {what}: {got.dtype}{list(got.shape)} "
              f"vs plain {want.dtype}{list(want.shape)}")
        err[name] = max(err[name], int((got.long() - want.long()).abs().max()) if got.numel() else 0)
        check(torch.equal(got, want), f"{name} == plain ({what})")
        calls[name] += 1

    for name, key in keys.items():
        for d in FV_FOLD_DATA:
            held("fold_in", threefry_kernel.fold_in_cuda(key, d), threefry.fold_in_plain(key, d), f"{name}, d = {d}")
    for n in FV_ROWS:
        for name, key in (keys if n <= 1000 else seed_keys).items():
            for density in FV_DENSITIES:
                mask = random_mask(gen, n, n, density, dev)
                for reps in (None, 3):
                    held("categorical", threefry_kernel.categorical_cuda(key, mask, reps),
                         threefry.categorical_masked_plain(key, mask, reps), f"N={n} {name} {density} reps={reps}")
        log(f"phase12: C1 at N={n}: == plain over {len(FV_DENSITIES)} densities x reps None/3 x "
            f"{len(keys if n <= 1000 else seed_keys)} keys")

    key = keys[f"seed {SEED}, split depth 2"]
    crossings = [c1_crossing(gen, key, *shape, held) for shape in (C1_BIG, *C1_MIDRUN)]
    for (rows, reps, cols), (cross_row, mid_run) in zip(C1_MIDRUN, crossings[1:]):
        check(mid_run, f"the {rows} x {reps} x {cols} draw passes 2**32 inside a run of row {cross_row}")
    for rows, cols in FV_WIDE:
        for density in FV_DENSITIES:
            mask = random_mask(gen, rows, cols, density, dev)
            for reps in (None, 3):
                held("categorical", threefry_kernel.categorical_cuda(key, mask, reps),
                     threefry.categorical_masked_plain(key, mask, reps), f"[{rows}, {cols}] {density} reps={reps}")
    # masks whose base lies 1..7 bytes past an 8-byte boundary: partial head runs
    for cols in (33, 1000, 20_003):
        base = random_mask(gen, 9, cols, 0.5, dev)
        for skip in range(1, 8):
            mask = base.view(-1)[skip:skip + 8 * cols].view(8, cols)
            for reps in (None, 3):
                held("categorical", threefry_kernel.categorical_cuda(key, mask, reps),
                     threefry.categorical_masked_plain(key, mask, reps), f"[8, {cols}] at +{skip} B reps={reps}")
    log(f"phase12: C1 == plain on long rows {FV_WIDE} and on masks 1..7 bytes past alignment")

    for n in (*FV_F1_ROWS, FV_BIG_N + 1):
        for density in (0.01, 0.5, 1.0):
            planes, cand = random_fullview_batch(gen, n, density, dev)
            tick = torch.tensor(37, dtype=torch.int32, device=dev)
            now = torch.tensor(7400, dtype=torch.int32, device=dev)
            a, b = [p.clone() for p in planes], [p.clone() for p in planes]
            fullview_kernel.apply_cuda(a, cand, tick, now, (5, 20, 6))
            fullview_kernel.apply_plain(b, cand, tick, now, (5, 20, 6))
            for name, x, y in zip(fullview.PLANES, a, b):
                check(torch.equal(x, y), f"F1 == plain on {name} (N={n}, density {density})")
            err["apply"] = max(err["apply"], max(int((x.long() - y.long()).abs().max()) for x, y in zip(a, b)))
            calls["apply"] += 1
            changed = sum(int((x != p).sum()) for x, p in zip(a, planes))
            # a batch of a few expected candidates (N = 1, 3) may change nothing
            check(n * n * density < 4 or changed > 0, f"F1 changed cells at N={n}, density {density}")
    planes, _ = random_fullview_batch(gen, 33, 0.5, dev)
    shifted = torch.full((33 * 33 + 1,), -1, dtype=torch.int32, device=dev)[1:].view(33, 33)
    try:
        fullview_kernel.apply_cuda(planes, shifted, tick, now, (5, 20, 6))
        check(False, "F1 refuses candidates that are not 16-byte aligned")
    except ValueError as e:
        check("16-byte" in str(e), f"F1's refusal of misaligned candidates names why: {e}")
    for i, nbytes in ((0, 1), (2, 2), (1, 4), (6, 8)):  # byte planes 4-byte, int32 planes 16-byte aligned
        raw = torch.empty(33 * 33 * planes[i].element_size() + 16, dtype=torch.uint8, device=dev)
        moved = list(planes)
        moved[i] = raw[nbytes:nbytes + planes[i].numel() * planes[i].element_size()].view(planes[i].dtype).view(33, 33)
        try:
            fullview_kernel.apply_cuda(moved, torch.full((33, 33), -1, dtype=torch.int32, device=dev), tick, now,
                                       (5, 20, 6))
            check(False, f"F1 refuses a {fullview.PLANES[i]} plane {nbytes} bytes past alignment")
        except ValueError as e:
            check("aligned" in str(e), f"F1's refusal of a misaligned {fullview.PLANES[i]} plane names why: {e}")
    torch.cuda.synchronize()
    log(f"phase12: F1 == plain on every plane over N = {FV_F1_ROWS + (FV_BIG_N + 1,)} x 3 densities, misaligned "
        f"planes refused; fold_in == plain at {FV_FOLD_DATA} over {len(keys)} keys; C1 == plain at the rows around "
        f"each 2**32 crossing of {(C1_BIG, *C1_MIDRUN)} (rows, mid-run: {crossings}); calls {calls}; max abs err "
        f"{err} ({time.perf_counter() - t0:.1f} s)")
    return {"max_abs_err": err, "calls": calls}


def fullview_victims(n: int, count: int) -> list[int]:
    """The recipe of BASELINE config 2 (``bench_loss1k``): ``count`` victims
    of ``default_rng(0)``."""
    return sorted(np.random.default_rng(0).choice(n, count, replace=False).tolist())


def fullview_faults(dev: torch.device, n: int, victims, drop: float):
    up = np.ones(n, bool)
    up[victims] = False
    return up, fullview.Faults(up=torch.as_tensor(up, device=dev), drop_rate=drop)


def fv_detected(state, victims, up: np.ndarray) -> bool:
    """Every live observer believes every victim >= FAULTY or has evicted it
    (``tests/engine_agreement.py:fv_detected``, in numpy)."""
    observers = up.copy()
    observers[list(victims)] = False
    obs = torch.as_tensor(np.flatnonzero(observers), device=state.status.device)
    vic = torch.as_tensor(list(victims), device=state.status.device)
    sub = state.status[obs][:, vic]
    gone = ~state.present[obs][:, vic]
    return bool(((sub >= FAULTY) | gone).all())


def phase13a_gate(dev: torch.device) -> dict:
    """BASELINE's north-star gate on the card: the port's LockstepRunner (the
    host oracle against the CUDA engine) at 1000 nodes, three down, in
    test_1k_node_conformance_gate's schedule.  Returns its wall time and
    the engine's share of it."""
    before = fv_launches()
    t0 = time.perf_counter()
    r = conformance.LockstepRunner(device=dev, **FV_GATE)
    engine_s = 0.0
    tick = r.vec.tick

    def timed_tick(*args, **kw):
        nonlocal engine_s
        t = time.perf_counter()
        out = tick(*args, **kw)
        torch.cuda.synchronize()
        engine_s += time.perf_counter() - t
        return out

    r.vec.tick = timed_tick
    up, faults = fullview_faults(dev, FV_GATE["n"], list(FV_GATE_DOWN), 0.0)
    r.run(FV_GATE_TICKS, faults=faults, check_every=FV_GATE_CHECK_EVERY)
    detected = [d for d in FV_GATE_DOWN if any(node.view.get(d, (0, 0))[0] != 0 for node in r.seq.nodes)]
    r.run(FV_GATE_HEALED, check_every=FV_GATE_CHECK_EVERY)
    t1 = time.perf_counter()
    r.assert_identical()
    wall = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in fv_launches().items()}
    ticks = FV_GATE_TICKS + FV_GATE_HEALED
    check(detected == list(FV_GATE_DOWN), f"the oracle suspected every node that was down: {detected}")
    check(launches["apply"] == 5 * ticks and launches["categorical"] == 0,
          f"the gate's engine applied F1 five times a tick and drew no target: {launches}")
    log(f"phase13a: the 1k lockstep gate holds on the card: {ticks} ticks (nodes {FV_GATE_DOWN} down for "
        f"{FV_GATE_TICKS}), checked every {FV_GATE_CHECK_EVERY} and at the end; wall {wall:.2f} s, the CUDA "
        f"engine {engine_s:.3f} s ({engine_s / wall:.2%}), the last assert_identical {time.perf_counter() - t1:.2f} s; "
        f"launches {launches}")
    return {"ticks": ticks, "wall_s": wall, "engine_s": engine_s, "engine_share": engine_s / wall,
            "launches": launches}


def fullview_block_profile(params, state, faults, ticks: int) -> dict:
    """``torch.profiler`` over ``ticks`` ticks from ``state``:
    device time by phase range and by kernel, the window (CUDA events), the
    device's busy share of it and kernel launches a tick.  The record is
    held against the wrappers' own counts: a record that misses a launch of
    the tick's kernels is taken again, twice at most, then fails."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        s = state
        torch.cuda.synchronize()
        before = fv_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiler_warmup()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(ticks):
                s = fullview.step(params, s, faults)
            end.record()
            torch.cuda.synchronize()
        counted = {name: n - before[name] for name, n in fv_launches().items()}
        kernels, phases = {}, {}
        for evt in prof.key_averages():
            on_device = evt.device_type == torch.autograd.DeviceType.CUDA
            if evt.key in fullview.PHASES and not on_device:
                phases[evt.key] = evt.device_time_total / 1e3
            elif on_device and MARK_TAG not in evt.key and evt.self_device_time_total > 0 and "(" in evt.key:
                kernels[evt.key] = (evt.count, evt.self_device_time_total / 1e3)
        recorded = {name: sum(c for key, (c, _) in kernels.items() if kname in key)
                    for name, kname in FV_KERNELS.items()}
        if recorded == counted:
            break
        log(f"profile: the profiler recorded {recorded} of the fullview kernels' launches, the wrappers counted "
            f"{counted}; profiling the block again")
    else:
        raise SystemExit(f"chip_smoke FAILED: the profiler's record of a {ticks}-tick fullview block misses "
                         f"launches: {recorded} recorded, {counted} counted")
    window_ms = start.elapsed_time(end)
    busy_ms = sum(ms for _, ms in kernels.values())
    launches = sum(c for c, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    return {"ticks": ticks, "window_ms": window_ms, "ms_a_tick": window_ms / ticks, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / window_ms, "kernel_launches_per_tick": launches / ticks,
            "port_launches": counted, "phases_kernel_ms": phases,
            "top_kernels": [{"name": name[:120], "launches": c, "ms": ms} for name, (c, ms) in top]}


def fullview_profiles(params, state, faults, what: str) -> dict:
    """An FV_BLOCK_TICKS block from ``state`` with the kernels and the same
    block with C1 and F1 swapped for their plain versions (timing only)."""
    out = {}
    for mode in ("kernels", "plain"):
        with plain_fullview() if mode == "plain" else contextlib.nullcontext():
            rec = out[mode] = fullview_block_profile(params, state, faults, FV_BLOCK_TICKS)
        log(f"phase13: {what}, {FV_BLOCK_TICKS} ticks on {'C1 and F1' if mode == 'kernels' else 'the plain versions'}:"
            f" window {rec['window_ms']:.3f} ms ({rec['ms_a_tick']:.3f} ms a tick), device busy "
            f"{rec['device_busy_ms']:.3f} ms ({rec['busy_share']:.1%}), {rec['kernel_launches_per_tick']:.2f} launches "
            f"a tick; kernel ms by phase {rec['phases_kernel_ms']}; the tick's kernels {rec['port_launches']}")
        for k in rec["top_kernels"]:
            log(f"phase13:   {k['ms']:.4f} ms  x{k['launches']}  {k['name']}")
    return out


def c1_alone(calls: list, rate: float, buf: torch.Tensor) -> dict:
    """C1 alone (profiler, after a clean L2 flush) on each recorded draw,
    beside its plain version (CUDA events) and its bound: the larger of the
    bytes (the mask and key read, the indices written) and the draws'
    operations (a cipher and xor, T1_OPS["bits"], and C1_SELECT_OPS an
    element) over the instruction rate.  The function draws only the
    elements it may pick: a row's allowed entries, or the whole row where it
    allows none, once a rep."""
    clean = lambda: buf.sum(dtype=torch.int64)  # noqa: E731
    out = {}
    for _, key, mask, reps in (c for c in calls if c[0] == "categorical"):
        rows, cols = mask.shape
        name = f"{'peers' if reps else 'targets'}_{rows}"
        fn = lambda: threefry_kernel.categorical_cuda(key, mask, reps)  # noqa: E731
        ref = lambda: threefry.categorical_masked_plain(key, mask, reps)  # noqa: E731
        check(torch.equal(fn(), ref()), f"C1 {name} == plain")
        ms = one_kernel_ms(profile_ms(fn, 20, clean, "reduce_kernel"), C1_F1_KERNELS["categorical"])
        # the elements a draw of a row must cipher: its allowed ones, or all
        # of it where none is allowed (the draw over the whole row)
        empty_rows = int((~mask.any(dim=1)).sum())
        draws = (reps or 1) * (int(mask.sum()) + empty_rows * cols)
        nbytes = mask.numel() + 4 * rows * (reps or 1) + 16
        ops = draws * (T1_OPS["bits"] + C1_SELECT_OPS)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        rec = out[name] = {"kernel_ms": ms, "plain_ms": time_ms(ref, 3, buf), "bound_ms": bound_ms,
                           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "bytes": nbytes,
                           "operations": ops, "draws": draws, "share_of_bound": bound_ms / ms}
        log(f"profile: C1 {name} ([{rows}, {reps or 1}, {cols}] draw): kernel alone {ms * 1e3:.2f} us after a clean "
            f"flush; {draws} draws ({empty_rows} rows allow none); plain {rec['plain_ms']:.4f} ms; bound "
            f"{bound_ms * 1e3:.2f} us ({rec['bound_by']}: {nbytes} bytes "
            f"{bytes_ms * 1e3:.2f} us, {ops} instructions ({T1_OPS['bits'] + C1_SELECT_OPS} an element) "
            f"{ops_ms * 1e3:.2f} us; {rec['share_of_bound']:.1%})")
    return out


LEGS = ("request", "response", "reverse-full-sync", "suspect", "timers")


def f1_needed_bytes(planes, after, cand, tick, now, timeouts) -> tuple:
    """The bytes one change application must move on these inputs, each
    input read once and each output written once where it changes:

    * the candidate plane, 4 bytes a cell, and tick and now_ms, 8;
    * a cell with a candidate reads its key's three planes — status (1),
      incarnation (4) and present (1) — 6 bytes: the refutation and the key
      order need nothing else;
    * a cell where a Suspect, Faulty or Tombstone applies off the diagonal
      reads its pending state (1 byte), as the same-state check needs it;
    * every plane byte that changes is written once (``after`` against
      ``planes``); has_change, pcount and deadline are only written.

    Applied cells are found by running the plain version on a copy whose
    pcount is -1 everywhere: an applied change resets pcount to 0."""
    n = cand.shape[0]
    marked = [p.clone() for p in planes]
    marked[4].fill_(-1)
    fullview_kernel.apply_plain(marked, cand, tick, now, timeouts)
    applied = marked[4] == 0
    detraction = (marked[0] == fullview.SUSPECT) | (marked[0] == fullview.FAULTY) | (marked[0] == fullview.TOMBSTONE)
    timer_reads = int((applied & detraction).sum() - (applied & detraction).diagonal().sum())
    cands = int((cand >= 0).sum())
    written = sum(int((a != p).sum()) * p.element_size() for a, p in zip(after, planes))
    return 4 * n * n + 8 + 6 * cands + timer_reads + written, cands, timer_reads, written


def f1_alone(calls: list, buf: torch.Tensor) -> dict:
    """F1 alone (profiler; the planes restored, then a clean L2 flush, before
    each run) on each recorded application of one tick, beside its plain
    version and its bound: the bytes these inputs need
    (:func:`f1_needed_bytes`) over 3.35 TB/s."""
    applies = [c for c in calls if c[0] == "apply"]
    check(len(applies) == 5, f"one tick records five F1 applications: {len(applies)}")
    out = {}
    for leg, (_, planes, cand, tick, now, timeouts) in zip(LEGS, applies):
        work = [p.clone() for p in planes]

        def restore_and_flush():
            for w, p in zip(work, planes):
                w.copy_(p)
            return buf.sum(dtype=torch.int64)

        fn = lambda: fullview_kernel.apply_cuda(work, cand, tick, now, timeouts)  # noqa: E731
        after = [p.clone() for p in planes]
        fullview_kernel.apply_plain(after, cand, tick, now, timeouts)
        restore_and_flush()
        fn()
        check(all(torch.equal(w, a) for w, a in zip(work, after)), f"F1 {leg} == plain")
        ms = one_kernel_ms(profile_ms(fn, 20, restore_and_flush, "reduce_kernel"), C1_F1_KERNELS["apply"])
        n = cand.shape[0]
        nbytes, cands, timer_reads, written = f1_needed_bytes(planes, after, cand, tick, now, timeouts)
        scratch = [p.clone() for p in planes]
        plain_ms = time_ms(lambda: fullview_kernel.apply_plain(scratch, cand, tick, now, timeouts), 3, buf)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rec = out[leg] = {"kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
                          "bytes": nbytes, "candidates": cands, "timer_checks": timer_reads, "bytes_written": written,
                          "share_of_bound": bound_ms / ms}
        log(f"profile: F1 {leg} at N={n}: {cands} candidates, {timer_reads} timer checks, {written} bytes change; "
            f"kernel alone "
            f"{ms * 1e3:.2f} us after a clean flush; plain {plain_ms:.4f} ms; bound {bound_ms * 1e3:.2f} us "
            f"({nbytes} bytes; {rec['share_of_bound']:.1%})")
    return out


def record_one_tick(params, state, faults) -> list:
    """The C1 and F1 calls of one tick from ``state``."""
    calls = []
    with record_fullview_calls(calls):
        fullview.step(params, state, faults)
    torch.cuda.synchronize()
    return calls


def phase13_fullview(dev: torch.device) -> dict:
    """13b: BASELINE config 2's shape on fullview (N = 1000, 10 victims of
    ``default_rng(0)``, 5 % loss, suspect_ticks 25), free-running on
    threefry until every live node holds every victim Faulty, checked every
    tick: the pinned tick and final-leaf digests.  Its launches are the main
    path's.  13c: the same recipe at N = 4096 (41 victims), 16 ticks, the
    pinned digests.  Then an 8-tick block at each size under the profiler,
    with the kernels and with C1 and F1 swapped for their plain versions,
    and C1 and F1 alone on one tick's calls at each size."""
    out = {}
    rate, _ = instruction_rate(dev)
    buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    # -- the main path: launch counts are 0 before it and read right after --
    n = FV_LOSS_N
    victims = fullview_victims(n, FV_LOSS_VICTIMS)
    up, faults = fullview_faults(dev, n, victims, FV_LOSS_DROP)
    threefry_kernel.reset_launches()
    fullview_kernel.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim = fullview.FullViewSim(n=n, seed=0, device=dev, suspect_ticks=FV_SUSPECT_TICKS)
    ticks = 0
    while ticks < FV_MAX_TICKS and not fv_detected(sim.state, victims, up):
        sim.tick(faults)
        ticks += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fv_launches()
    check(ticks == PIN_FV_LOSS_TICKS, f"loss1k on fullview detected in {ticks} ticks (JAX: {PIN_FV_LOSS_TICKS})")
    digests = leaf_digests(fullview.state_to_numpy(sim.state), fullview.FullViewState._fields)
    for name, want in PIN_FV_LOSS.items():
        check(digests[name] == want, f"loss1k final {name} digest == the JAX package's")
    want = {"categorical": 2 * ticks, "fold_in": ticks, "split": 2 * ticks, "uniform": 3 * ticks, "apply": 5 * ticks}
    check(launches == want, f"the loss1k run launched C1 twice, F1 five times, fold_in once, split twice and "
                            f"uniform three times a tick: {launches}")
    log(f"phase13b: loss1k on fullview (N={n}, victims {victims}, drop {FV_LOSS_DROP}) detected in {ticks} ticks "
        f"== JAX, final leaf digests == JAX; wall {wall:.3f} s with a check every tick "
        f"({wall / ticks * 1e3:.3f} ms a tick); launches {launches}")
    out["loss1k"] = {"n": n, "ticks": ticks, "wall_s": wall, "ms_a_tick": wall / ticks * 1e3, "launches": launches}
    small_calls = record_one_tick(sim.params, sim.state, faults)
    out["loss1k"]["profiles"] = fullview_profiles(sim.params, sim.state, faults, f"N={n} from tick {ticks}")
    del sim

    # -- 13c: the engine at a size that loads the card --
    n = FV_BIG_N
    victims = fullview_victims(n, FV_BIG_VICTIMS)
    up, faults = fullview_faults(dev, n, victims, FV_LOSS_DROP)
    sim = fullview.FullViewSim(n=n, seed=0, device=dev, suspect_ticks=FV_SUSPECT_TICKS)
    state_bytes = sum(t.numel() * t.element_size() for t in sim.state)
    before = fv_launches()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    sim.run(FV_BIG_TICKS, faults)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    big_launches = {k: v - before[k] for k, v in fv_launches().items()}
    digests = leaf_digests(fullview.state_to_numpy(sim.state), fullview.FullViewState._fields)
    for name, want in PIN_FV_BIG.items():
        check(digests[name] == want, f"N={n} tick-{FV_BIG_TICKS} {name} digest == the JAX package's")
    log(f"phase13c: N={n} ({state_bytes / 1e6:.1f} MB of state), {len(victims)} victims, drop {FV_LOSS_DROP}: "
        f"{FV_BIG_TICKS} ticks in {ms:.3f} ms ({ms / FV_BIG_TICKS:.3f} ms a tick), leaf digests == JAX; launches "
        f"{big_launches}")
    out["n4096"] = {"n": n, "ticks": FV_BIG_TICKS, "ms": ms, "ms_a_tick": ms / FV_BIG_TICKS,
                    "state_bytes": state_bytes, "launches": big_launches}
    big_calls = record_one_tick(sim.params, sim.state, faults)
    out["n4096"]["profiles"] = fullview_profiles(sim.params, sim.state, faults, f"N={n} from tick {FV_BIG_TICKS}")
    del sim
    out["c1_alone"] = c1_alone(big_calls + small_calls, rate, buf)
    out["f1_alone"] = f1_alone(big_calls, buf)
    out["f1_alone_1000"] = f1_alone(small_calls, buf)
    return out


def run_fullview(dev: torch.device) -> tuple[list, dict]:
    """Phases 12-13 on ``dev``; returns the records of C1 and F1 and the
    timings."""
    p12 = phase12_fullview_kernels(dev)
    gate = phase13a_gate(dev)
    fv = phase13_fullview(dev)
    main = fv["loss1k"]["launches"]
    c1, f1 = fv["c1_alone"][f"targets_{FV_BIG_N}"], fv["f1_alone"]
    f1_ms = statistics.fmean(r["kernel_ms"] for r in f1.values())
    f1_bound = statistics.fmean(r["bound_ms"] for r in f1.values())
    kernels = [{
        "name": "threefry_categorical", "route": "cuda", "source": "ringpop_tpu_torch/csrc/threefry.cu",
        "replaces": "ringpop_tpu/sim/fullview.py:296 (jax.random.categorical: XLA's Gumbel draw, add and argmax; "
                    "also :375, the ping-req peers; no Pallas kernel)",
        "launches": main["categorical"], "max_abs_err": p12["max_abs_err"]["categorical"],
        "state": f"targets [{FV_BIG_N}, {FV_BIG_N}] on tick {FV_BIG_TICKS + 1} of phase 13c",
        "ms": c1["kernel_ms"], "plain_ms": c1["plain_ms"], "bound_ms": c1["bound_ms"], "bound_by": c1["bound_by"],
        "share_of_bound": c1["share_of_bound"], "library_ms": None,
        "library": "none: torch.multinomial draws from Philox, another function",
        "by_case": fv["c1_alone"],
    }, {
        "name": "fullview_apply", "route": "cuda", "source": "ringpop_tpu_torch/csrc/fullview.cu",
        "replaces": "ringpop_tpu/sim/fullview.py:171 (_apply_batch: XLA's fused elementwise passes; no Pallas "
                    "kernel)",
        "launches": main["apply"], "max_abs_err": p12["max_abs_err"]["apply"],
        "state": f"the five applications of tick {FV_BIG_TICKS + 1} of phase 13c (N={FV_BIG_N}), mean a launch",
        "ms": f1_ms, "plain_ms": statistics.fmean(r["plain_ms"] for r in f1.values()), "bound_ms": f1_bound,
        "bound_by": "bytes", "share_of_bound": f1_bound / f1_ms, "library_ms": None,
        "library": "none", "by_leg": f1,
    }]
    return kernels, {"fullview_kernels": p12, "fullview_gate": gate, "fullview": fv}


# -- phase 14: the telemetry plane, the chaos and topology plans, D1 and P1 --

OUT_DIR = Path("chip_smoke_out")  # phase 14's journals and the whole record, beside the log (git ignores it)
TEL_ROWS = (1, 31, 33, 4097, 1_000_000)
TEL_SLOTS = (40, 64, 256)
TEL_WORDS = (1, 2, 8)
TEL_WIDE_ROWS = (1 << 24) + 1  # an int8 [TEL_WIDE_ROWS, 256] plane: 2**32 + 256 elements, 4.3 GB
# R1's cases: phase 14a's rows, and 1023, whose last first-level window
# ends in one row of padding (the 31-row lanes)
R1_ROWS = TEL_ROWS + (1023,)
# D1's work an element: the yardstick counts two fmix32 (shift, xor,
# multiply, shift, xor, multiply, shift, xor: 8 each; the value's xor folds
# into the inner mix's last three-input xor) and the wrapping add.  The
# function's least work is less: within an aligned chunk of c consecutive
# flat indices (c = 16 int8 or bool elements, 4 int32) the inner mix's
# first shift is the chunk's and its xor one with the lane (none for lane
# 0); the inner mix's last shift by 16 and the outer mix's first cancel,
# the value entering as w = v ^ v >> 16 (for an int32 a shift and a third
# input of an xor; for a byte a byte permute, and half an instruction of
# its word's sign mask); two elements' adds fold into one three-input add:
# (c - 1) / c + 4 multiplies + 3 shifts and 3 xors + 2 for the value + 1/2,
# 13.25 an int32 element (c = 4), the least of the kinds, held to no more
# than D1's marginal SASS an element (d1_sass_per_element)
FMIX32_OPS = 8
D1_YARDSTICK_OPS = 2 * FMIX32_OPS + 1
D1_OPS = 13.25
D1_MEASURED_KIND = 3  # csrc/telemetry.cu's int8 walk on aligned chunks (kInt8 * 2 + 1): the headline's pcount
# the headline with telemetry before D1's redesign and R1 (PERF.md's
# findings; NVIDIA H100 80GB HBM3, 700 W), logged beside this run's in 14b
TELEMETRY_BEFORE = {"launches_a_tick_off": 958, "launches_a_tick_on": 975, "detect_ms_off_spread": [3042.06, 3940.30],
                  "detect_ms_on_spread": [3072.30, 3760.64]}
# the chaos and topology runs (cli/simbench.py:_run_chaos_scenario): the
# lifecycle engine at suspect_ticks 10 on the counter stream, 16-tick blocks
TEL_SEED, TEL_HORIZON, TEL_BLOCK, TEL_SUSPECT_TICKS = 0, 256, 16, 10
TEL_CHURN_N, TEL_CHURN_K = 100_000, 256  # simbench churn100k (cli/simbench.py:1888-1894)
TEL_TOPO_N, TEL_TOPO_K = 4096, 32  # bench_topo_chaos's width (cli/simbench.py:1939-1941)
# BASELINE config 4 (cli/simbench.py:752-788): the delta engine, a 30 % partition, then the heal
TEL_PART_N, TEL_PART_K, TEL_PART_MINORITY = 1_000_000, 128, 0.3
TEL_PART_TICKS, TEL_HEAL_TICKS = 256, 4096


def tel_records(keys: tuple, rows: list) -> list[dict]:
    """Pinned journal records, stored as rows of values in ``keys``' order."""
    return [dict(zip(keys, row)) for row in rows]


# pinned from the JAX package (ringpop_tpu.sim.telemetry, .chaos, .topology)
# run on the CPU; tests/test_torch_chip_smoke_pins_telemetry.py recomputes them
PIN_TEL_HEADLINE = {  # phase 9's recipe with a TelemetrySink and journal_views=True
    'detect': [128, True],
    'converge': [0, True],
    'records': tel_records(('census_alive', 'census_faulty', 'census_suspect', 'census_tombstone', 'decl_alive', 'decl_faulty',
                   'decl_suspect', 'decl_tombstone', 'detect_frac', 'heal_attempts', 'num_members', 'ping_req_send',
                   'ping_send', 'ping_timeout', 'refuted', 'rumors_active', 'rumors_expired', 'rumors_piggybacked',
                   'state_digest', 'tick', 'ticks', 'timer_fired', 'views_agree', 'views_sum'), [
        (999000, 1000, 0, 0, 0, 1000, 1000, 0, 1.0, 1, 1000000, 249958.0, 127744136.0, 83406.0, 0.0, 0, 0.0, 12302178304.0,
         2244873187, 128, 128, 1000.0, True, 1194085248),
        (999000, 1000, 0, 0, 0, 0, 0, 0, 1.0, 0, 1000000, 0.0, 0.0, 0.0, 0.0, 0, 0.0, 0.0, 2244873187, 128, 0, 0.0, True,
         1194085248),
    ]),
}
PIN_TEL_CHURN = {  # churn100k: the block records and the verdict
    'score': {'kind': 'score',
     'scenario': 'churn100k',
     'n': 100000,
     'ticks': 256,
     'blocks': 16,
     'block_granularity_ticks': 16,
     'events': [{'kind': 'crash', 'tick': 8, 'nodes': 250}, {'kind': 'crash', 'tick': 16, 'nodes': 250},
                {'kind': 'crash', 'tick': 24, 'nodes': 250}, {'kind': 'crash', 'tick': 32, 'nodes': 250},
                {'kind': 'restart', 'tick': 72, 'nodes': 187}, {'kind': 'restart', 'tick': 80, 'nodes': 187},
                {'kind': 'restart', 'tick': 88, 'nodes': 188}, {'kind': 'restart', 'tick': 96, 'nodes': 188}],
     'time_to_detect': [[8, 136], [16, 128], [24, 120], [32, 112]],
     'time_to_detect_median': 128,
     'rumor_half_life': [[8, 88], [16, 80], [24, 72], [32, 64]],
     'rumor_half_life_median': 80,
     'refutations': 552,
     'false_positive_suspects': 0,
     'suspects_declared': 802,
     'faulty_declared': 677,
     'heal_attempts': 4,
     'final_detect_frac': 1.0,
     'rejoin_convergence_ticks': 48},
    'records': tel_records(('census_alive', 'census_faulty', 'census_suspect', 'census_tombstone', 'decl_alive', 'decl_faulty',
                   'decl_suspect', 'decl_tombstone', 'detect_frac', 'heal_attempts', 'num_members', 'ping_req_send',
                   'ping_send', 'ping_timeout', 'refuted', 'rumors_active', 'rumors_expired', 'rumors_piggybacked',
                   'state_digest', 'tick', 'ticks', 'timer_fired'), [
        (100000, 0, 0, 0, 0, 0, 250, 0, 0.0, 0, 100000, 5977.0, 1596003.0, 1997.0, 0.0, 250, 0.0, 305210.0, 1733536778, 16,
         16, 0.0),
        (99746, 0, 254, 0, 0, 254, 6, 0, 0.0, 0, 100000, 29508.0, 1580066.0, 9902.0, 0.0, 256, 0.0, 157241632.0,
         1315632472, 32, 16, 5.0),
        (99744, 254, 2, 0, 0, 2, 254, 0, 0.254, 0, 100000, 36753.0, 1568165.0, 12373.0, 0.0, 256, 0.0, 190946224.0,
         1411297407, 48, 16, 2.0),
        (99491, 413, 96, 0, 0, 254, 158, 0, 0.413, 1, 100000, 33145.0, 1568133.0, 11158.0, 0.0, 256, 0.0, 285694048.0,
         2521764500, 64, 16, 111.0),
        (99265, 510, 225, 0, 187, 63, 73, 0, 0.432907, 0, 100000, 23808.0, 1569634.0, 8003.0, 187.0, 256, 0.0, 181015040.0,
         3623333920, 80, 16, 63.0),
        (99446, 380, 174, 0, 245, 5, 0, 0, 0.588, 0, 100000, 13556.0, 1579780.0, 4544.0, 245.0, 256, 0.0, 166687072.0,
         1096924057, 96, 16, 90.0),
        (99697, 224, 79, 0, 120, 38, 61, 0, 0.604, 0, 100000, 4808.0, 1589966.0, 1606.0, 120.0, 214, 0.0, 170455424.0,
         1484307973, 112, 16, 78.0),
        (99811, 189, 0, 0, 0, 61, 0, 0, 0.756, 0, 100000, 3151.0, 1591782.0, 1052.0, 0.0, 122, 0.0, 252492736.0,
         2693672935, 128, 16, 61.0),
        (99750, 250, 0, 0, 0, 0, 0, 0, 1.0, 0, 100000, 30.0, 1592007.0, 10.0, 0.0, 0, 0.0, 35472732.0, 3995203184, 144, 16,
         0.0),
        (99750, 250, 0, 0, 0, 0, 0, 0, 1.0, 0, 100000, 0.0, 1592014.0, 0.0, 0.0, 0, 0.0, 0.0, 1453683169, 160, 16, 0.0),
        (99750, 250, 0, 0, 0, 0, 0, 0, 1.0, 1, 100000, 0.0, 1592006.0, 0.0, 0.0, 0, 0.0, 0.0, 3721052117, 176, 16, 0.0),
        (99750, 250, 0, 0, 0, 0, 0, 0, 1.0, 0, 100000, 0.0, 1592018.0, 0.0, 0.0, 0, 0.0, 0.0, 1879082517, 192, 16, 0.0),
        (99750, 250, 0, 0, 0, 0, 0, 0, 1.0, 0, 100000, 0.0, 1592009.0, 0.0, 0.0, 0, 0.0, 0.0, 3904409273, 208, 16, 0.0),
        (99750, 250, 0, 0, 0, 0, 0, 0, 1.0, 0, 100000, 0.0, 1592012.0, 0.0, 0.0, 0, 0.0, 0.0, 2095685515, 224, 16, 0.0),
        (99750, 250, 0, 0, 0, 0, 0, 0, 1.0, 2, 100000, 0.0, 1592008.0, 0.0, 0.0, 0, 0.0, 0.0, 3899533600, 240, 16, 0.0),
        (99750, 250, 0, 0, 0, 0, 0, 0, 1.0, 0, 100000, 0.0, 1592011.0, 0.0, 0.0, 0, 0.0, 0.0, 3403783422, 256, 16, 0.0),
    ]),
}
PIN_TEL_TOPO = {  # zone_loss at 4096 x 32 with the per-tier counters
    'score': {'kind': 'score',
     'scenario': 'topo_zone_loss',
     'n': 4096,
     'ticks': 256,
     'blocks': 16,
     'block_granularity_ticks': 16,
     'events': [{'kind': 'crash', 'tick': 8, 'nodes': 1024}, {'kind': 'restart', 'tick': 128, 'nodes': 1024}],
     'time_to_detect': [[8, 120]],
     'time_to_detect_median': 120,
     'rumor_half_life': [[8, 120]],
     'rumor_half_life_median': 120,
     'refutations': 163,
     'false_positive_suspects': 0,
     'suspects_declared': 163,
     'faulty_declared': 137,
     'heal_attempts': 3,
     'final_detect_frac': 1.0,
     'rejoin_convergence_ticks': None,
     'suspects_by_tier': {'same_rack': 0, 'cross_rack': 0, 'cross_zone': 56, 'cross_region': 107},
     'false_positive_by_tier': {'same_rack': 0, 'cross_rack': 0, 'cross_zone': 0, 'cross_region': 19},
     'time_to_detect_by_tier': {'same_rack': None, 'cross_rack': None, 'cross_zone': 8, 'cross_region': 8}},
    'records': tel_records(('census_alive', 'census_faulty', 'census_suspect', 'census_tombstone', 'decl_alive', 'decl_faulty',
                   'decl_suspect', 'decl_tombstone', 'detect_frac', 'false_suspects_cross_rack',
                   'false_suspects_cross_region', 'false_suspects_cross_zone', 'false_suspects_same_rack',
                   'heal_attempts', 'num_members', 'ping_req_send', 'ping_send', 'ping_timeout', 'refuted',
                   'rumors_active', 'rumors_expired', 'rumors_piggybacked', 'state_digest', 'suspects_cross_rack',
                   'suspects_cross_region', 'suspects_cross_zone', 'suspects_same_rack', 'tick', 'ticks',
                   'timer_fired'), [
        (4095, 0, 1, 0, 1, 0, 32, 0, 0.0, 0.0, 3.0, 0.0, 0.0, 0, 4096, 24271.0, 46604.0, 10740.0, 1.0, 32, 0.0, 36194.0,
         1540743063, 0.0, 3.0, 29.0, 0.0, 16, 16, 0.0),
        (4069, 0, 27, 0, 2, 26, 0, 0, 0.0, 0.0, 0.0, 0.0, 0.0, 0, 4096, 31485.0, 34495.0, 14650.0, 2.0, 32, 0.0, 798668.0,
         2041507727, 0.0, 0.0, 0.0, 0.0, 32, 16, 6.0),
        (4066, 29, 1, 0, 0, 7, 29, 0, 0.02832, 0.0, 0.0, 0.0, 0.0, 0, 4096, 28585.0, 35624.0, 13226.0, 0.0, 32, 0.0,
         902290.0, 1623492751, 0.0, 28.0, 1.0, 0.0, 48, 16, 6.0),
        (4038, 54, 4, 0, 0, 25, 28, 0, 0.052734, 0.0, 3.0, 0.0, 0.0, 1, 4096, 31303.0, 34158.0, 14512.0, 0.0, 32, 0.0,
         1033806.0, 1118186243, 0.0, 26.0, 2.0, 0.0, 64, 16, 8.0),
        (4013, 58, 25, 0, 4, 24, 1, 0, 0.056641, 0.0, 1.0, 0.0, 0.0, 0, 4096, 26359.0, 36246.0, 12268.0, 4.0, 32, 0.0,
         688117.0, 272985130, 0.0, 1.0, 0.0, 0.0, 80, 16, 1.0),
        (4008, 83, 5, 0, 0, 7, 31, 0, 0.081055, 0.0, 0.0, 0.0, 0.0, 0, 4096, 26328.0, 36134.0, 12178.0, 0.0, 32, 0.0,
         702587.0, 2719203180, 0.0, 7.0, 24.0, 0.0, 96, 16, 4.0),
        (3989, 89, 18, 0, 0, 25, 0, 0, 0.086914, 0.0, 0.0, 0.0, 0.0, 0, 4096, 31195.0, 33680.0, 14471.0, 0.0, 32, 0.0,
         1005781.0, 212731181, 0.0, 0.0, 0.0, 0.0, 112, 16, 21.0),
        (3959, 114, 23, 0, 1, 23, 31, 0, 1.0, 0.0, 1.0, 0.0, 0.0, 0, 4096, 22873.0, 37294.0, 10557.0, 1.0, 32, 0.0,
         787369.0, 2526429339, 0.0, 31.0, 0.0, 0.0, 128, 16, 0.0),
        (3952, 137, 7, 0, 32, 0, 0, 0, 1.0, 0.0, 0.0, 0.0, 0.0, 0, 4096, 8790.0, 60435.0, 3074.0, 32.0, 32, 0.0, 1006740.0,
         3521778933, 0.0, 0.0, 0.0, 0.0, 144, 16, 0.0),
        (3998, 91, 7, 0, 46, 0, 0, 0, 1.0, 0.0, 0.0, 0.0, 0.0, 0, 4096, 6035.0, 61749.0, 2108.0, 46.0, 32, 0.0, 1394755.0,
         3775032008, 0.0, 0.0, 0.0, 0.0, 160, 16, 0.0),
        (4048, 43, 5, 0, 50, 0, 0, 0, 1.0, 0.0, 0.0, 0.0, 0.0, 1, 4096, 7770.0, 61868.0, 2717.0, 50.0, 32, 0.0, 1010040.0,
         1720716603, 0.0, 0.0, 0.0, 0.0, 176, 16, 7.0),
        (4084, 12, 0, 0, 16, 0, 1, 0, 1.0, 0.0, 1.0, 0.0, 0.0, 0, 4096, 7047.0, 62699.0, 2467.0, 16.0, 13, 0.0, 1030902.0,
         568165163, 0.0, 1.0, 0.0, 0.0, 192, 16, 0.0),
        (4096, 0, 0, 0, 3, 0, 3, 0, 1.0, 0.0, 3.0, 0.0, 0.0, 0, 4096, 9610.0, 62185.0, 3351.0, 3.0, 5, 0.0, 346755.0,
         3885126873, 0.0, 3.0, 0.0, 0.0, 208, 16, 0.0),
        (4096, 0, 0, 0, 3, 0, 4, 0, 1.0, 0.0, 4.0, 0.0, 0.0, 0, 4096, 7663.0, 62856.0, 2680.0, 3.0, 6, 0.0, 256693.0,
         761142671, 0.0, 4.0, 0.0, 0.0, 224, 16, 0.0),
        (4096, 0, 0, 0, 3, 0, 1, 0, 1.0, 0.0, 1.0, 0.0, 0.0, 1, 4096, 7924.0, 62770.0, 2766.0, 3.0, 4, 0.0, 400650.0,
         2023134662, 0.0, 1.0, 0.0, 0.0, 240, 16, 0.0),
        (4096, 0, 0, 0, 2, 0, 2, 0, 1.0, 0.0, 2.0, 0.0, 0.0, 0, 4096, 9756.0, 62138.0, 3398.0, 2.0, 4, 0.0, 144112.0,
         1542879955, 0.0, 2.0, 0.0, 0.0, 256, 16, 0.0),
    ]),
}
PIN_TEL_PARTITION = {  # partition1m: the delta journal's (tick, coverage, digest) records
    'partition_ticks': 256,
    'heal_ticks': 8,
    'converged': True,
    'records': tel_records(('coverage', 'digest', 'tick'), [
        (0.3, 2651896, 64),
        (0.3, 1361611419, 128),
        (0.3, 3525348601, 192),
        (0.3, 3039263630, 256),
        (1.0, 4194064686, 264),
    ]),
}


def records_match(got: list, want: list) -> bool:
    """Are two journals' records equal: the same keys, every value of the
    same type and equal, the float32 sums bit for bit?"""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if set(g) != set(w):
            return False
        for key, wv in w.items():
            gv = g[key]
            if type(gv) is not type(wv) or gv != wv:
                return False
    return True


def record_diff(got: list, want: list) -> list:
    """The first differing records, for a failure's message."""
    out = [(i, {k: (g.get(k), w.get(k)) for k in set(g) | set(w) if g.get(k) != w.get(k)})
           for i, (g, w) in enumerate(zip(got, want)) if g != w]
    return out[:3] + ([f"{len(got)} records, {len(want)} pinned"] if len(got) != len(want) else [])


def tel_headline_run(dev, n: int = LIFE_N, k: int = LIFE_K, journal=None):
    """The headline with telemetry: phase 9's recipe (``LifecycleSim(n, k,
    seed=0, rng="counter")``, bench.py's victims down,
    ``run_until_detected(max_ticks=4096, check_every=32,
    blocks_per_dispatch=8)``, then ``run_until_converged``) with a
    ``TelemetrySink`` (journalled when ``journal`` is given) and
    ``journal_views=True``.  Returns (the result, the sim)."""
    victims, faults = headline_faults(dev, n)
    sink = telemetry.TelemetrySink(journal=journal)
    sim = lifecycle.LifecycleSim(n=n, k=k, seed=LIFE_SEED, rng="counter", telemetry=sink, journal_views=True,
                                 device=dev)
    detect = sim.run_until_detected(victims, faults, max_ticks=LIFE_MAX_TICKS, check_every=LIFE_CHECK_EVERY,
                                    blocks_per_dispatch=8)
    converge = sim.run_until_converged(faults, max_ticks=LIFE_MAX_TICKS, check_every=LIFE_CHECK_EVERY,
                                       blocks_per_dispatch=8)
    return {"detect": list(detect), "converge": list(converge), "records": sink.records}, sim


def tel_chaos_run(dev, plan, n: int, k: int, scenario: str, tiers: bool = False, journal=None, mesh=None):
    """A chaos or topology scenario as simbench runs it
    (``_run_chaos_scenario``): the lifecycle engine under ``plan`` for
    TEL_HORIZON ticks in TEL_BLOCK-tick blocks with telemetry on (the
    per-tier counters with ``tiers``), then ``score_blocks``.  With a
    ``mesh`` the sim is this rank's block (every rank's records are the
    whole state's).  Returns ({"records", "score"}, the sim)."""
    sink = telemetry.TelemetrySink(journal=journal)
    sim = lifecycle.LifecycleSim(n=n, k=k, seed=TEL_SEED, suspect_ticks=TEL_SUSPECT_TICKS, rng="counter",
                                 telemetry=sink, telemetry_tiers=tiers, device=dev, exchange_mesh=mesh)
    for _ in range(TEL_HORIZON // TEL_BLOCK):
        sim.run(TEL_BLOCK, plan)
    score = chaos.score_blocks(sink.records, plan, n=n, scenario=scenario)
    if journal is not None:
        journal.score(score)
    return {"records": sink.records, "score": score}, sim


def tel_partition_run(dev, n: int = TEL_PART_N, k: int = TEL_PART_K, journal=None) -> dict:
    """BASELINE config 4 (``bench_partition1m``): ``DeltaSim(n, k, seed=0,
    rng="counter", telemetry_sink=...)``, the first 30 % of the nodes
    partitioned off until converged (TEL_PART_TICKS at most), then healed
    (TEL_HEAL_TICKS at most), one (tick, coverage, digest) record a 64-tick
    block."""
    group = np.zeros(n, np.int32)
    group[: int(TEL_PART_MINORITY * n)] = 1
    up = torch.ones(n, dtype=torch.bool, device=dev)
    part = delta.DeltaFaults(up=up, group=torch.from_numpy(group).to(dev))
    heal = delta.DeltaFaults(up=up)
    sink = telemetry.TelemetrySink(journal=journal)
    sim = delta.DeltaSim(n=n, k=k, seed=TEL_SEED, rng="counter", telemetry_sink=sink, device=dev)
    t_part, _ = sim.run_until_converged(part, max_ticks=TEL_PART_TICKS)
    t_heal, ok = sim.run_until_converged(heal, max_ticks=TEL_HEAL_TICKS)
    return {"partition_ticks": t_part, "heal_ticks": t_heal, "converged": ok, "records": sink.records}


def digest_leaves(gen: torch.Generator, n: int, k: int, dev, kind: str = "random") -> list:
    """A lifecycle-shaped leaf set: 0-d int32, int32[K], int8[K], int32
    [N, W] and int8 [N, K] planes (full of negatives), bool[N], int8[N],
    int64[2]."""
    w = packbits.n_words(k)
    i32 = lambda *s: torch.randint(-(2**31), 2**31 - 1, s, generator=gen, dtype=torch.int32, device=dev)  # noqa
    i8 = lambda *s: torch.randint(-128, 0 if kind == "negative" else 128, s, generator=gen,  # noqa: E731
                                  dtype=torch.int8, device=dev)
    return [torch.tensor(7, dtype=torch.int32, device=dev), i32(k), i8(k), i32(n, w), i8(n, k),
            torch.randint(0, 2, (n,), generator=gen, device=dev).to(torch.bool), i8(n),
            torch.randint(0, 2**32, (2,), generator=gen, dtype=torch.int64, device=dev)]


def check_digest(leaves, what: str, offset: int = 0) -> None:
    got = telemetry_kernel.state_digest_cuda(leaves)
    want = telemetry.tree_digest_plain(leaves)
    check(torch.equal(got, want), f"D1 {what}: tree digest {int(got)} == plain {int(want)}")
    for leaf in leaves[:1] + leaves[3:5]:
        got = telemetry_kernel.state_digest_cuda([leaf], offset=offset, final=False)
        want = telemetry.leaf_digest_sum_plain(leaf, offset)
        check(torch.equal(got, want), f"D1 {what}: leaf sum of {leaf.dtype}{list(leaf.shape)} at offset {offset}")


def random_accumulate_inputs(gen: torch.Generator, n: int, w: int, dev, kind: str) -> dict:
    """P1's inputs at [N, W]: random, empty (all zero) or full (all ones)
    planes and masks, over accumulators already holding random counts."""
    def plane():
        if kind == "empty":
            return torch.zeros((n, w), dtype=torch.int32, device=dev)
        if kind == "full":
            return torch.full((n, w), -1, dtype=torch.int32, device=dev)
        return torch.randint(-(2**31), 2**31 - 1, (n, w), generator=gen, dtype=torch.int32, device=dev)

    def mask(*s):
        if kind in ("empty", "full"):
            return torch.full(s, kind == "full", dtype=torch.bool, device=dev)
        return torch.rand(s, generator=gen, device=dev) < 0.5

    counts = lambda *s: torch.randint(0, 1000, s, generator=gen, dtype=torch.int32, device=dev)  # noqa: E731
    acc = {"piggybacked": counts(n, w), "expired": counts(n, w), "pings": counts(n), "ping_reqs": counts(n),
           "probes_failed": counts(n), "incarnation_bumps": counts(n), "base_timer_fires": counts(n)}
    legs = dict(sent_w=plane(), resp_w=plane(), ride_ok=plane(), mid_ride_w=plane(), delivered=mask(n),
                probing=mask(n), peer_ok=mask(n, 3), refute=mask(n), placed=mask(n), base_fired=mask(n))
    return {"acc": acc, "legs": legs}


def r1_inputs(gen: torch.Generator, n: int, w: int, dev) -> list:
    """R1's inputs at [N, W], as a record's: int32 [N] counts in [2**24,
    2**26) (every sum past 2**24), a uint32 plane and an int32 plane of any
    bits, an int32 [N, 4] summed by column, a bool [N] and an int32 [40]."""
    i32 = lambda *s: torch.randint(-(2**31), 2**31 - 1, s, generator=gen, dtype=torch.int32, device=dev)  # noqa
    big = torch.randint(2**24, 2**26, (n,), generator=gen, dtype=torch.int32, device=dev)
    return [(big, False, False), (i32(n, w), True, False), (i32(n, w), False, False),
            (torch.randint(2**24, 2**26, (n, 4), generator=gen, dtype=torch.int32, device=dev), False, True),
            (torch.randint(0, 2, (n,), generator=gen, device=dev).to(torch.bool), False, False),
            (i32(40), False, False)]


def check_r1(inputs, what: str) -> None:
    """R1 == its plain version, bit for bit, on ``inputs``."""
    got = telemetry.f32_sums(inputs)
    want = torch.cat([telemetry.f32_sum_plain(x, u, c).reshape(-1) for x, u, c in inputs])
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
          f"R1 {what}: {got.tolist()} == plain {want.tolist()}")


def phase14a_telemetry_kernels(dev: torch.device) -> dict:
    """D1, P1 and R1 == their plain versions on the card: D1 on
    lifecycle-shaped leaf sets at N = 1, 31, 33, 4097, 1,000,000 x K = 40,
    64, 256 (random and all-negative int8 planes), with leaf sums at
    offsets 0, 5 and 2**32 - 3, leaves 1..15 elements past alignment (every
    byte of a 16-byte vector for int8 and bool: D1's heads and tails), both
    engines' full states, and one int8 plane of 2**32 + 256 elements, whose
    flat index wraps (== its two halves' leaf sums at their offsets); P1 at
    N = 1, 31, 33, 4097, 1,000,000 x W = 1, 2, 8 on random, empty and full
    planes; R1, bit for bit, at N = R1_ROWS x W = 1, 2, 8 (r1_inputs: sums
    past 2**24, unsigned and signed planes, a sum by column, a mask)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 14)
    t0 = time.perf_counter()
    cases = 0
    for n in TEL_ROWS:
        for k in TEL_SLOTS:
            for kind in ("random", "negative"):
                leaves = digest_leaves(gen, n, k, dev, kind)
                for offset in (0, 5, 2**32 - 3):
                    check_digest(leaves, f"N={n} K={k} {kind}", offset)
                cases += 1
    base = digest_leaves(gen, 4097, 64, dev, "negative")
    for off in range(1, 16):
        shifted = [at_offset(x, off * x.element_size()) for x in base]
        check_digest(shifted, f"bases {off} elements past alignment", offset=off)
        cases += 1
    params = lifecycle.LifecycleParams(n=LIFE_N, k=LIFE_K, rng="counter")
    life = lifecycle.init_state(params, seed=LIFE_SEED, device=dev)
    victims, faults = headline_faults(dev, LIFE_N)
    for _ in range(3):
        life = lifecycle.step(params, life, faults)
    dparams = delta.DeltaParams(n=DELTA_N, k=DELTA_K, rng="counter")
    dstate = delta.init_state(dparams, seed=DELTA_SEED, device=dev)
    for state, what in ((life, "the lifecycle headline's state at tick 3"), (dstate, "the delta 1M x 128 state")):
        got, want = telemetry.tree_digest(list(state)), telemetry.tree_digest_plain(list(state))
        check(torch.equal(got, want), f"D1 on {what}: {int(got)} == plain {int(want)}")
        cases += 1
    del life, dstate
    torch.cuda.empty_cache()
    wide = torch.randint(-128, 0, (TEL_WIDE_ROWS, LIFE_K), generator=gen, dtype=torch.int8, device=dev)
    got = telemetry_kernel.state_digest_cuda([wide], final=False)
    want = telemetry.leaf_digest_sum_plain(wide)
    halves = (telemetry_kernel.state_digest_cuda([wide[: TEL_WIDE_ROWS - 1]], final=False)
              + telemetry_kernel.state_digest_cuda([wide[TEL_WIDE_ROWS - 1:]], offset=(TEL_WIDE_ROWS - 1) * LIFE_K,
                                                   final=False)) & 0xFFFF_FFFF
    check(torch.equal(got, want) and torch.equal(got, halves),
          f"D1 over {wide.numel()} elements (the flat index wraps): {int(got)} == plain {int(want)} == halves")
    del wide
    torch.cuda.empty_cache()
    log(f"phase14a: D1 == plain over {cases} leaf sets (3 offsets each) and the {TEL_WIDE_ROWS} x {LIFE_K} int8 "
        f"plane ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    p1_cases = 0
    for n in TEL_ROWS:
        for w in TEL_WORDS:
            for kind in ("random", "empty", "full"):
                inp = random_accumulate_inputs(gen, n, w, dev, kind)
                got = {name: x.clone() for name, x in inp["acc"].items()}
                want = {name: x.clone() for name, x in inp["acc"].items()}
                telemetry_kernel.accumulate_cuda(got, **inp["legs"])
                telemetry.accumulate_plain(want, **inp["legs"])
                for name in got:
                    check(torch.equal(got[name], want[name]), f"P1 N={n} W={w} {kind}: {name} == plain")
                p1_cases += 1
    log(f"phase14a: P1 == plain over {p1_cases} cases ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    r1_cases = 0
    for n in R1_ROWS:
        for w in TEL_WORDS:
            check_r1(r1_inputs(gen, n, w, dev), f"N={n} W={w}")
            r1_cases += 1
    log(f"phase14a: R1 == plain, bit for bit, over {r1_cases} cases of six inputs, N = {R1_ROWS} x W = {TEL_WORDS} "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"d1_cases": cases, "p1_cases": p1_cases, "r1_cases": r1_cases, "max_abs_err": 0}


def d1_bound(leaves, rate: float) -> dict:
    nbytes = sum(x.numel() * x.element_size() for x in leaves) + 4 * (len(leaves) + 1) + 8
    elements = sum(x.numel() for x in leaves)
    ops = elements * D1_OPS
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return {"bytes": nbytes, "elements": elements, "operations": ops, "bytes_ms": bytes_ms, "operations_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def d1_sass_per_element() -> dict:
    """D1's SASS instructions an element on the headline's path (the int8
    walk on aligned chunks): the difference between two measurement builds
    that walk that kind alone (RP_D1_ONLY), with 4 and with 2 vectors in
    flight a thread (RP_D1_UNROLL), over the 32 elements between; beside
    the built kernel's opcodes and registers."""
    defines = {u: (f"RP_D1_ONLY={D1_MEASURED_KIND}", f"RP_D1_UNROLL={u}") for u in (2, 4)}
    with ThreadPoolExecutor(2) as ex:
        libs = dict(zip(defines, ex.map(lambda d: telemetry_kernel.build(d), defines.values())))
    name_of = lambda sym: "D1" if "telemetry_state_digest" in sym else None  # noqa: E731
    counts = {u: sum(next(iter(sass_opcodes(lib, name_of).values())).values()) for u, lib in libs.items()}
    lib = telemetry_kernel.build()
    per_element = (counts[4] - counts[2]) / (2 * 16)
    check(D1_OPS <= per_element, f"D1_OPS {D1_OPS} <= D1's marginal SASS an element {per_element}")
    return {"per_element": per_element, "builds": counts, "opcodes": next(iter(sass_opcodes(lib, name_of).values())),
            "registers": ptxas_registers(lib, name_of).get("D1")}


def r1_bound(inputs) -> dict:
    nbytes = sum(x.numel() * x.element_size() for x, _, _ in inputs)
    nbytes += 4 * sum(x.shape[1] if c else 1 for x, _, c in inputs)
    return {"bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


def p1_bound(n: int, w: int, p: int) -> dict:
    # six planes read, two written; five counters read and written; five
    # [N] masks and peer_ok [N, P] read
    nbytes = 8 * 4 * n * w + 10 * 4 * n + (5 + p) * n
    return {"bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


def telemetry_alone(dev: torch.device, life_state, delta_state) -> dict:
    """D1 and P1 alone (profiler, by name, after a flush that leaves the L2
    cache clean) at the main path's shapes: D1 on the headline's state (1M
    x 256) and on the delta 1M x 128 state, P1 on the headline's tick (1M x
    8 words, 3 peers), each beside its bound, with its wrapper call (CUDA
    events) and its plain version."""
    rate, _ = instruction_rate(dev)
    buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    clean = lambda: buf.sum(dtype=torch.int64)  # noqa: E731
    out = {}
    for name, state in (("d1_lifecycle_1m_256", life_state), ("d1_delta_1m_128", delta_state)):
        leaves = list(state)
        fn = lambda: telemetry_kernel.state_digest_cuda(leaves)  # noqa: E731
        ref = lambda: telemetry.tree_digest_plain(leaves)  # noqa: E731
        check(torch.equal(fn(), ref()), f"{name}: D1 == plain")
        ms = one_kernel_ms(profile_ms(fn, 20, clean, "reduce_kernel"), "telemetry_state_digest")
        rec = out[name] = {"kernel_ms": ms, "call_ms": time_ms(fn, 20, buf), "plain_ms": time_ms(ref, 3, buf),
                           **d1_bound(leaves, rate)}
        rec["share_of_bound"] = rec["bound_ms"] / ms
        rec["yardstick_ms"] = rec["elements"] * D1_YARDSTICK_OPS / rate * 1e3
        rec["share_of_yardstick"] = rec["yardstick_ms"] / ms
        log(f"profile: D1 {name}: kernel alone {ms * 1e3:.2f} us after a clean flush; call {rec['call_ms'] * 1e3:.2f} "
            f"us; plain {rec['plain_ms']:.3f} ms; bound {rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}: "
            f"{rec['bytes']} bytes {rec['bytes_ms'] * 1e3:.2f} us, {rec['elements']} elements x {D1_OPS} "
            f"{rec['operations_ms'] * 1e3:.2f} us; {rec['share_of_bound']:.1%}); the yardstick ({D1_YARDSTICK_OPS} "
            f"an element) {rec['yardstick_ms'] * 1e3:.2f} us, {rec['share_of_yardstick']:.1%}")
    out["d1_sass"] = sass = d1_sass_per_element()
    log(f"profile: D1 SASS: {sass['per_element']} instructions an int8 element (builds {sass['builds']}), "
        f"{sass['registers']} registers; opcodes {sass['opcodes']}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 15)
    n, w = LIFE_N, packbits.n_words(LIFE_K)
    inp = random_accumulate_inputs(gen, n, w, dev, "random")
    acc = inp["acc"]
    fn = lambda: telemetry_kernel.accumulate_cuda(acc, **inp["legs"])  # noqa: E731
    ref = lambda: telemetry.accumulate_plain(acc, **inp["legs"])  # noqa: E731
    ms = one_kernel_ms(profile_ms(fn, 20, clean, "reduce_kernel"), "telemetry_accumulate")
    rec = out["p1_lifecycle_1m_8"] = {"kernel_ms": ms, "call_ms": time_ms(fn, 20, buf),
                                      "plain_ms": time_ms(ref, 5, buf), **p1_bound(n, w, 3)}
    rec["share_of_bound"] = rec["bound_ms"] / ms
    log(f"profile: P1 at {n} x {w} words: kernel alone {ms * 1e3:.2f} us after a clean flush; call "
        f"{rec['call_ms'] * 1e3:.2f} us; plain {rec['plain_ms']:.3f} ms; bound {rec['bound_ms'] * 1e3:.2f} us "
        f"({rec['bytes']} bytes; {rec['share_of_bound']:.1%})")
    # R1 on a headline record's inputs (fetch's: the [N] counters, the two
    # [N, W] planes, the timer legs, the census masks), its two kernels' sum
    inputs = [(acc["pings"], False, False), (acc["ping_reqs"], False, False), (acc["probes_failed"], False, False),
              (acc["incarnation_bumps"], False, False), (acc["piggybacked"], True, False),
              (acc["expired"], True, False),
              (torch.randint(0, 1000, (LIFE_K,), generator=gen, dtype=torch.int32, device=dev), False, False),
              (acc["base_timer_fires"], False, False), (inp["legs"]["delivered"], False, False),
              (inp["legs"]["probing"], False, False)]
    fn = lambda: telemetry.f32_sums(inputs)  # noqa: E731
    ref = lambda: [telemetry.f32_sum_plain(x, u, c) for x, u, c in inputs]  # noqa: E731
    check_r1(inputs, "on a headline record's inputs")
    found = profile_ms(fn, 20, clean, "reduce_kernel")
    windows_ms, levels_ms = one_kernel_ms(found, "telemetry_sum_windows"), one_kernel_ms(found, "telemetry_sum_levels")
    ms = windows_ms + levels_ms
    rec = out["r1_lifecycle_1m_8"] = {"kernel_ms": ms, "windows_ms": windows_ms, "levels_ms": levels_ms,
                                      "call_ms": time_ms(fn, 20, buf), "plain_ms": time_ms(ref, 3, buf),
                                      **r1_bound(inputs)}
    rec["share_of_bound"] = rec["bound_ms"] / ms
    log(f"profile: R1 on a headline record ({n} x {w} words): kernels alone {ms * 1e3:.2f} us (windows "
        f"{windows_ms * 1e3:.2f}, levels {levels_ms * 1e3:.2f}) after a clean flush; call {rec['call_ms'] * 1e3:.2f} "
        f"us; plain {rec['plain_ms']:.3f} ms; bound {rec['bound_ms'] * 1e3:.2f} us ({rec['bytes']} bytes; "
        f"{rec['share_of_bound']:.1%})")
    return out


def tick_profile(params, state, faults, tel, ticks: int) -> dict:
    """``ticks`` lifecycle ticks from ``state`` under ``torch.profiler``,
    with the telemetry accumulator ``tel`` or without (None): the window
    (CUDA events), kernel launches a tick and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiler_warmup()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = state
        for _ in range(ticks):
            if tel is None:
                out = lifecycle.step(params, out, faults)
            else:
                out, tel = lifecycle.step(params, out, faults, tel)
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end)
    launches, busy, p1 = 0, 0.0, (0, 0.0)
    for evt in prof.key_averages():
        if (evt.device_type == torch.autograd.DeviceType.CUDA and evt.key not in lifecycle.PHASES
                and evt.key != "telemetry" and MARK_TAG not in evt.key and evt.self_device_time_total > 0):
            launches += evt.count
            busy += evt.self_device_time_total / 1e3
            if "telemetry_accumulate" in evt.key:
                p1 = (evt.count, evt.self_device_time_total / 1e3)
    return {"ticks": ticks, "window_ms": window_ms, "ms_a_tick": window_ms / ticks,
            "launches_a_tick": launches / ticks, "busy_share": busy / window_ms,
            "p1_launches": p1[0], "p1_ms_a_launch": p1[1] / max(p1[0], 1)}


def phase14b_headline(dev: torch.device) -> dict:
    """The headline with telemetry on, at full width: the main path's run
    (counts at 0 before it), its ticks and final-leaf digests == phase 9's
    pins, its block records (with state_digest, views_sum, views_agree) ==
    the JAX pins; detection in turns with telemetry off and on, and a
    32-tick block on and off under the profiler (ms and launches a tick)."""
    path = OUT_DIR / "phase14_headline.jsonl"
    path.parent.mkdir(exist_ok=True)
    packbits_kernel.reset_launches()
    lifecycle_kernel.reset_launches()
    threefry_kernel.reset_launches()
    telemetry_kernel.reset_launches()
    torch.cuda.synchronize()
    with telemetry.TelemetryJournal(str(path)) as journal:
        journal.header("lifecycle", "headline-telemetry", {"n": LIFE_N, "k": LIFE_K, "seed": LIFE_SEED})
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res, sim = tel_headline_run(dev, journal=journal)
        end.record()
        torch.cuda.synchronize()
    launches = {**port_launches(), **{f"telemetry_{k}": v for k, v in telemetry_kernel.launches.items()}}
    check(res["detect"] == [PIN_LIFE_DETECT_TICKS, True] and res["converge"] == [PIN_LIFE_CONVERGE_TICKS, True],
          f"telemetry on: detected {res['detect']}, converged {res['converge']} == phase 9's pins")
    digests = leaf_digests(lifecycle.state_to_numpy(sim.state), lifecycle.LifecycleState._fields)
    for name, want in PIN_LIFE.items():
        check(digests[name] == want, f"telemetry on: final {name} digest == phase 9's pin (transparency)")
    check(records_match(res["records"], PIN_TEL_HEADLINE["records"]),
          f"headline block records == the JAX pins: {record_diff(res['records'], PIN_TEL_HEADLINE['records'])}")
    flushes = len(res["records"])
    check(launches["telemetry_accumulate"] == PIN_LIFE_DETECT_TICKS and launches["telemetry_state_digest"] == flushes
          and launches["telemetry_f32_sums"] == 2 * flushes and launches["row_reduce"] == 3 * PIN_LIFE_DETECT_TICKS
          and not any(v for k, v in launches.items() if k.startswith("threefry_")),
          f"P1 once a tick ({PIN_LIFE_DETECT_TICKS}), D1 once and R1 twice a block record ({flushes}), S1 3x a tick "
          f"and no T1 on the counter stream: {launches}")
    check(len(telemetry.read_journal(str(path))) == 1 + flushes, "the journal holds the header and every block")
    log(f"phase14b: telemetry on, detected in {res['detect'][0]} ticks and converged {res['converge'][0]} later == "
        f"phase 9's pins, final digests == PIN_LIFE, {flushes} block records == JAX; launches {launches}; "
        f"{start.elapsed_time(end):.1f} ms with the views")
    victims, faults = headline_faults(dev, LIFE_N)
    walls = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        s = lifecycle.LifecycleSim(n=LIFE_N, k=LIFE_K, seed=LIFE_SEED, rng="counter", device=dev,
                                   telemetry=telemetry.TelemetrySink() if mode == "on" else None)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        ticks, ok = s.run_until_detected(victims, faults, max_ticks=LIFE_MAX_TICKS, check_every=LIFE_CHECK_EVERY,
                                         blocks_per_dispatch=8)
        b.record()
        torch.cuda.synchronize()
        check(ok and ticks == PIN_LIFE_DETECT_TICKS, f"telemetry {mode}: detected in {ticks} ticks")
        walls[mode].append(a.elapsed_time(b))
        del s
    params = lifecycle.LifecycleParams(n=LIFE_N, k=LIFE_K, rng="counter")
    state = lifecycle.init_state(params, seed=LIFE_SEED, device=dev)
    for _ in range(LIFE_TWIN_TICKS):
        state = lifecycle.step(params, state, faults)
    blocks = {"off": tick_profile(params, state, faults, None, LIFE_CHECK_EVERY),
              "on": tick_profile(params, state, faults, telemetry.zeros(params, device=dev), LIFE_CHECK_EVERY)}
    log(f"phase14b: detection ms telemetry off {walls['off']}, on {walls['on']} (before: off "
        f"{TELEMETRY_BEFORE['detect_ms_off_spread']}, on {TELEMETRY_BEFORE['detect_ms_on_spread']}); 32-tick block "
        f"from tick {LIFE_TWIN_TICKS}: off {blocks['off']}, on {blocks['on']} (before: launches a tick off "
        f"{TELEMETRY_BEFORE['launches_a_tick_off']}, on {TELEMETRY_BEFORE['launches_a_tick_on']}; R1's 2 a journalled "
        f"block come on top, {2 * flushes} over the run's {PIN_LIFE_DETECT_TICKS} ticks)")
    delta_state = delta.init_state(delta.DeltaParams(n=DELTA_N, k=DELTA_K, rng="counter"), seed=DELTA_SEED,
                                   device=dev)
    alone = telemetry_alone(dev, sim.state, delta_state)
    return {"launches": launches, "records": len(res["records"]), "detect_ms": walls, "blocks": blocks,
            "alone": alone}


def phase14cde_scenarios(dev: torch.device) -> dict:
    """14c: simbench's churn100k (100,000 x 256, churn plan, horizon 256,
    16-tick blocks, suspect_ticks 10); 14d: the topology plane at
    bench_topo_chaos's width (4096 x 32, ``topo_scenario_plan("zone_loss")``
    solo, the per-tier counters armed); 14e: BASELINE config 4,
    ``partition1m`` at 1,000,000 x 128 on the delta engine.  Each run's
    records and verdict == the JAX pins, with its wall time."""
    out = {}
    for name, plan_fn, n, k, tiers, pin in (
            ("churn100k", lambda: chaos.scenario_plan("churn", TEL_CHURN_N, seed=TEL_SEED, horizon=TEL_HORIZON,
                                                      device=dev), TEL_CHURN_N, TEL_CHURN_K, False, PIN_TEL_CHURN),
            ("topo_zone_loss", lambda: topology.topo_scenario_plan("zone_loss", TEL_TOPO_N, seed=TEL_SEED,
                                                                   horizon=TEL_HORIZON, device=dev),
             TEL_TOPO_N, TEL_TOPO_K, True, PIN_TEL_TOPO)):
        plan = plan_fn()
        path = OUT_DIR / f"phase14_{name}.jsonl"
        telemetry_kernel.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with telemetry.TelemetryJournal(str(path)) as journal:
            journal.header("lifecycle", name, {"n": n, "k": k, "seed": TEL_SEED})
            res, sim = tel_chaos_run(dev, plan, n, k, name, tiers=tiers, journal=journal)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(telemetry_kernel.launches)
        check(records_match(res["records"], pin["records"]),
              f"{name}: block records == the JAX pins: {record_diff(res['records'], pin['records'])}")
        check(res["score"] == pin["score"], f"{name}: the verdict == the JAX pin: {res['score']}")
        check(launches == {"accumulate": TEL_HORIZON, "state_digest": TEL_HORIZON // TEL_BLOCK,
                           "f32_sums": 2 * TEL_HORIZON // TEL_BLOCK},
              f"{name}: P1 once a tick, D1 once and R1 twice a block: {launches}")
        journaled = telemetry.read_journal(str(path))
        check(journaled[-1] == json.loads(json.dumps(res["score"])) and len(journaled) == 2 + len(res["records"]),
              f"{name}: the scored journal round-trips")
        log(f"phase14: {name} at {n} x {k}: {len(res['records'])} block records and the verdict == JAX "
            f"(ttd median {res['score']['time_to_detect_median']}, fp {res['score']['false_positive_suspects']}, "
            f"rejoin {res['score']['rejoin_convergence_ticks']}); wall {wall:.3f} s host clock to a synchronize; "
            f"launches {launches}")
        out[name] = {"n": n, "k": k, "wall_s": wall, "launches": launches, "score": res["score"]}
        del sim
    telemetry_kernel.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = tel_partition_run(dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(telemetry_kernel.launches)
    got = [telemetry._to_host(r) for r in res["records"]]
    pin = PIN_TEL_PARTITION
    check([res["partition_ticks"], res["heal_ticks"], res["converged"]]
          == [pin["partition_ticks"], pin["heal_ticks"], pin["converged"]],
          f"partition1m: partition {res['partition_ticks']}, heal {res['heal_ticks']} ticks, converged "
          f"{res['converged']} == JAX {pin}")
    check(records_match(got, pin["records"]), f"partition1m: records == JAX: {record_diff(got, pin['records'])}")
    check(launches == {"accumulate": 0, "state_digest": len(got), "f32_sums": 0},
          f"partition1m: D1 once a record: {launches}")
    log(f"phase14e: partition1m at {TEL_PART_N} x {TEL_PART_K}: partition {res['partition_ticks']} ticks, heal "
        f"{res['heal_ticks']}, converged, {len(got)} (tick, coverage, digest) records == JAX; wall {wall:.3f} s; "
        f"launches {launches}")
    out["partition1m"] = {"wall_s": wall, "launches": launches, "partition_ticks": res["partition_ticks"],
                          "heal_ticks": res["heal_ticks"]}
    return out


def run_telemetry(dev: torch.device) -> tuple[list, dict]:
    """Phase 14 on ``dev``; returns the records of D1 and P1 and the
    timings."""
    p14a = phase14a_telemetry_kernels(dev)
    head = phase14b_headline(dev)
    scen = phase14cde_scenarios(dev)
    d1, p1, r1 = (head["alone"][k] for k in ("d1_lifecycle_1m_256", "p1_lifecycle_1m_8", "r1_lifecycle_1m_8"))
    main = head["launches"]
    kernels = [{
        "name": "telemetry_state_digest", "route": "cuda", "source": "ringpop_tpu_torch/csrc/telemetry.cu",
        "replaces": "ringpop_tpu/sim/telemetry.py:408 (tree_digest over leaf_digest_sum :373: XLA's fused passes; "
                    "no Pallas kernel)",
        "launches": main["telemetry_state_digest"], "max_abs_err": p14a["max_abs_err"],
        "state": f"the headline's final state ({LIFE_N} x {LIFE_K})",
        "ms": d1["kernel_ms"], "call_ms": d1["call_ms"], "plain_ms": d1["plain_ms"], "bound_ms": d1["bound_ms"],
        "bound_by": d1["bound_by"], "share_of_bound": d1["share_of_bound"], "library_ms": None,
        "library": "none", "least_ops_per_element": D1_OPS, "yardstick_ops": D1_YARDSTICK_OPS,
        "share_of_yardstick": d1["share_of_yardstick"], "sass": head["alone"]["d1_sass"],
        "by_case": {k: v for k, v in head["alone"].items() if k.startswith("d1_") and k != "d1_sass"},
    }, {
        "name": "telemetry_accumulate", "route": "cuda", "source": "ringpop_tpu_torch/csrc/telemetry.cu",
        "replaces": "ringpop_tpu/sim/telemetry.py:148 (accumulate's [N, W] and [N] legs: XLA's elementwise "
                    "passes; no Pallas kernel)",
        "launches": main["telemetry_accumulate"], "max_abs_err": p14a["max_abs_err"],
        "state": f"the headline's tick ({LIFE_N} x {packbits.n_words(LIFE_K)} words, 3 peers)",
        "ms": p1["kernel_ms"], "call_ms": p1["call_ms"], "plain_ms": p1["plain_ms"], "bound_ms": p1["bound_ms"],
        "bound_by": "bytes", "share_of_bound": p1["share_of_bound"], "library_ms": None, "library": "none",
    }, {
        "name": "telemetry_f32_sums", "route": "cuda", "source": "ringpop_tpu_torch/csrc/telemetry.cu",
        "replaces": "ringpop_tpu/sim/telemetry.py:280-332 (fetch's float32 sums: XLA:CPU's reduce-windows; no "
                    "Pallas kernel)",
        "launches": main["telemetry_f32_sums"], "max_abs_err": p14a["max_abs_err"],
        "state": f"a headline record's inputs ({LIFE_N} x {packbits.n_words(LIFE_K)} words)",
        "ms": r1["kernel_ms"], "call_ms": r1["call_ms"], "plain_ms": r1["plain_ms"], "bound_ms": r1["bound_ms"],
        "bound_by": "bytes", "share_of_bound": r1["share_of_bound"], "library_ms": None,
        "library": "none: torch.sum adds in another order",
    }]
    return kernels, {"telemetry_kernels": p14a, "telemetry_headline": head, "telemetry_scenarios": scen}


# -- phase 15: the scenario fleet (sim/montecarlo, sim/scenarios, sim/snapshot) --

# simbench's fleet rows at full scale (ringpop_tpu/cli/simbench.py): montecarlo
# (:232-262) and mc_churn (:1064-1143), n 4096 x k 32, 32 replicas seeded 0..31,
# threefry, 4 victims from default_rng(seed); mc_chaos's scored journal
# (:1249-1262) on the corner of its grid (doses 0 and churn_max, losses 0
# and 0.1: 4 of its 128 scenarios), 256 ticks in 16-tick blocks
FLEET_N, FLEET_K, FLEET_B, FLEET_SEED = 4096, 32, 32, 0
FLEET_MC_MAX_TICKS, FLEET_CHURN_MAX_TICKS = 1024, 4096
FLEET_CHURN_SEED, FLEET_CONTRAST_SEED = FLEET_SEED + 777, FLEET_SEED + 778
FLEET_LOSSES, FLEET_HORIZON, FLEET_BLOCK, FLEET_SAVE_AT = (0.0, 0.1), 256, 16, 128
FLEET_TWIN_B, FLEET_TWIN_TICKS = 2, 4  # 15's twin: kernels against plain versions on the fleet's shapes
FLEET_PROFILE_TICKS = 2  # a profiled fleet block at B = 1 and B = FLEET_B
FLEET_KERNELS = ("slot_walk", "first_live_learner", "row_reduce", "threefry", "telemetry_accumulate",
                 "telemetry_state_digest", "telemetry_f32_sums")
# pinned from the JAX package (ringpop_tpu.sim.montecarlo, .scenarios) run on
# the CPU; tests/test_torch_chip_smoke_pins_fleet.py recomputes them
# 15a: the distribution and every replica's final digest, in replica order
PIN_FLEET_MC = {
    "distribution": {"n_replicas": 32, "detected": 32, "ticks_median": 36.0, "ticks_p90": 36.0, "ticks_max": 37.0,
                     "sim_s_median": 7.2, "ticks_all": [35, 35, 35, 36, 36, 36, 36, 36, 36, 36, 36, 36, 36, 36, 36,
                      36, 36, 36, 36, 36, 36, 36, 36, 36, 36, 36, 36, 36, 36, 36, 36, 37]},
    "digests": [2419896041, 13971730, 276234646, 2622331047, 2758430302, 2109515306, 957886429, 3859830618,
                342299360, 120943324, 2340974905, 2921628582, 343585947, 1926029024, 3920164558, 3235900662,
                901479654, 793882333, 637095638, 4005361127, 2347540153, 2036482530, 3159803321, 1753515270,
                3137142401, 526025267, 1215035414, 599611794, 443439922, 481916085, 398596524, 203288392],
}
# 15b: the dose-response curve, its cliff and the contrasts
PIN_FLEET_CHURN = {
    "churn_ticks": [[0, 37], [4, 36], [8, 36], [12, 35], [17, 36], [21, 36], [25, 36], [29, 35], [33, 36], [37, 48],
                    [41, 46], [45, 46], [50, 47], [54, 46], [58, 46], [62, 46], [66, 51], [70, 51], [74, 56],
                    [78, 56], [83, 56], [87, 63], [91, 62], [95, 62], [99, 62], [103, 63], [107, 96], [111, 96],
                    [116, 96], [120, 97], [124, 97], [128, 96]],
    "churn_cliff_at": 107, "cliff_jump_ticks": 33,
    "cliff_contrast": {"maxp_default": 60, "k32_maxp_default": [[0, 37], [128, 99]],
                       "k32_maxp_x3": [[0, 37], [128, 99]], "k64_maxp_default": [[0, 37], [128, 46]]},
}
# 15c: the verdicts and digests at the horizon
PIN_FLEET_SCORED = {
    "scores": tel_records(("kind", "scenario", "n", "ticks", "blocks", "block_granularity_ticks", "events",
                          "time_to_detect", "time_to_detect_median", "rumor_half_life", "rumor_half_life_median",
                          "refutations", "false_positive_suspects", "suspects_declared", "faulty_declared",
                          "heal_attempts", "final_detect_frac", "rejoin_convergence_ticks", "scenario_id", "churn",
                          "loss", "part", "dose_index"), [
        ("score", "mc_chaos", 4096, 256, 16, 16, [], [], None, [], None, 0, 0, 4, 4, 6, 1.0, None, 0, 0, 0.0, 0.0, 0),
        ("score", "mc_chaos", 4096, 256, 16, 16, [], [], None, [], None, 0, 0, 132, 132, 6, 1.0, None, 1, 128, 0.0,
         0.0, 1),
        ("score", "mc_chaos", 4096, 256, 16, 16, [], [], None, [], None, 265, 265, 272, 4, 6, 1.0, None, 2, 0, 0.1,
         0.0, 0),
        ("score", "mc_chaos", 4096, 256, 16, 16, [], [], None, [], None, 169, 169, 306, 132, 6, 1.0, None, 3, 128,
         0.1, 0.0, 1),
    ]),
    "digests": {0: 2855582472, 1: 1248461985, 2: 2164527130, 3: 3539042073},
}


def fleet_victims(n: int) -> list[int]:
    """simbench's victims: 4 of n from ``np.random.default_rng(FLEET_SEED)``."""
    return sorted(np.random.default_rng(FLEET_SEED).choice(n, size=4, replace=False).tolist())


def fleet_faults(dev, n: int):
    victims = fleet_victims(n)
    up = np.ones(n, bool)
    up[victims] = False
    return victims, delta.DeltaFaults(up=torch.from_numpy(up).to(dev))


def fleet_digests(states) -> list[int]:
    """Every replica's state digest, in replica order."""
    return [int(telemetry.tree_digest(lifecycle.LifecycleState(*(x[b] for x in states))))
            for b in range(int(states.tick.shape[0]))]


def fleet_mc_run(dev, n: int = FLEET_N, b: int = FLEET_B, k: int = FLEET_K,
                 max_ticks: int = FLEET_MC_MAX_TICKS) -> tuple[dict, "montecarlo.MonteCarlo"]:
    """simbench ``montecarlo``: ``detection_latency_distribution``'s recipe
    (B replicas seeded FLEET_SEED.., the victims down, detection checked
    every tick) through ``MonteCarlo``, so that the final states can be
    digested.  Returns ({"distribution", "digests"}, the fleet)."""
    victims, faults = fleet_faults(dev, n)
    params = lifecycle.LifecycleParams(n=n, k=k)
    mc = montecarlo.MonteCarlo(params, range(FLEET_SEED, FLEET_SEED + b), device=dev)
    ticks, detected = mc.run_until_detected(victims, faults, max_ticks=max_ticks, check_every=1)
    dist = montecarlo._distribution(ticks, detected, mc.n_replicas, params.tick_ms / 1000.0)
    return {"distribution": dist, "digests": fleet_digests(mc.states)}, mc


def fleet_churn_run(dev, n: int = FLEET_N, b: int = FLEET_B, k: int = FLEET_K,
                    max_ticks: int = FLEET_CHURN_MAX_TICKS) -> dict:
    """simbench ``mc_churn``: ``detection_latency_under_churn`` with up to
    n // 32 background crashes, the cliff by ``scenarios.locate_cliff``,
    and the three 2-replica contrasts at the saturating dose (k, k with
    three times maxP, 2k)."""
    victims = fleet_victims(n)
    churn_max = n // 32
    seeds = range(FLEET_SEED, FLEET_SEED + b)
    out = montecarlo.detection_latency_under_churn(n=n, seeds=seeds, victims=victims, churn_max=churn_max, k=k,
                                                   max_ticks=max_ticks, churn_seed=FLEET_CHURN_SEED, device=dev)
    cliff_at, jump = scenarios.locate_cliff(out["churn_ticks"])
    base = lifecycle.LifecycleParams(n=n, k=k)
    contrast = {"maxp_default": base.resolved_max_p()}
    for label, kw in ((f"k{k}_maxp_default", dict(k=k)), (f"k{k}_maxp_x3", dict(k=k, max_p=3 * base.resolved_max_p())),
                      (f"k{2 * k}_maxp_default", dict(k=2 * k))):
        o = montecarlo.detection_latency_under_churn(
            n=n, seeds=[FLEET_SEED, FLEET_SEED + 1], victims=victims, churn_max=churn_max, max_ticks=max_ticks,
            churn_seed=FLEET_CONTRAST_SEED, device=dev, **kw)
        contrast[label] = o["churn_ticks"]
    return {"churn_ticks": out["churn_ticks"], "churn_cliff_at": cliff_at, "cliff_jump_ticks": jump,
            "detected": out["detected"], "cliff_contrast": contrast}


def fleet_grid(dev, n: int):
    """The corner of mc_chaos's grid: doses 0 and n // 32, losses 0 and 0.1."""
    plan, meta = scenarios.scenario_grid(n, victims=fleet_victims(n), doses=[0, n // 32], losses=FLEET_LOSSES,
                                         churn_seed=FLEET_CHURN_SEED, device=dev)
    return plan, meta, scenarios.grid_seeds(meta, FLEET_SEED)


def fleet_scored_run(dev, ckpt: str, n: int = FLEET_N, k: int = FLEET_K, horizon: int = FLEET_HORIZON,
                     save_at: int = FLEET_SAVE_AT) -> dict:
    """mc_chaos's scored journal on the grid's corner: a ``FleetSweep`` run
    to ``save_at``, saved to ``ckpt``, run on to the horizon; then restored
    from ``ckpt`` into a new sweep and run to the horizon.  Returns both
    runs' ``scores()`` and ``digests()``."""
    params = lifecycle.LifecycleParams(n=n, k=k)
    plan, meta, seeds = fleet_grid(dev, n)
    sweep = scenarios.FleetSweep(params, plan, meta, seeds, horizon=horizon, journal_every=FLEET_BLOCK,
                                 scenario="mc_chaos", device=dev)
    sweep.run(until_tick=save_at)
    sweep.save(ckpt)
    sweep.run()
    out = {"scores": sweep.scores(), "digests": sweep.digests()}
    del sweep
    resumed = scenarios.FleetSweep.restore(ckpt, params, plan, meta, seeds, device=dev)
    resumed.run()
    out.update(resumed_scores=resumed.scores(), resumed_digests=resumed.digests(),
               resumed_from=resumed.resumed["from_tick"])
    return out


def fleet_launches() -> dict[str, int]:
    """The wrapper counts of the fleet path's kernels: L1, L2, S1, T1 (all
    its entries), P1, D1 and R1."""
    counts = port_launches()
    return {"slot_walk": counts["slot_walk"], "first_live_learner": counts["first_live_learner"],
            "row_reduce": counts["row_reduce"],
            "threefry": sum(v for key, v in counts.items() if key.startswith("threefry_")),
            **{f"telemetry_{key}": v for key, v in telemetry_kernel.launches.items()}}


def reset_fleet_launches() -> None:
    packbits_kernel.reset_launches()
    lifecycle_kernel.reset_launches()
    threefry_kernel.reset_launches()
    telemetry_kernel.reset_launches()
    torch.cuda.synchronize()


@contextlib.contextmanager
def plain_telemetry():
    """Route ``ops/telemetry_kernel``'s P1, D1 and R1 on CUDA tensors to their
    plain versions (on the card) for the duration."""
    names = ("accumulate_cuda", "state_digest_cuda", "f32_sums_cuda")
    saved = [getattr(telemetry_kernel, name) for name in names]

    def d1_plain(leaves, offset: int = 0, final: bool = True):
        if final:
            return telemetry.tree_digest_plain(list(leaves))
        return telemetry.leaf_digest_sum_plain(leaves[0], offset)

    def r1_plain(inputs):
        return torch.cat([telemetry.f32_sum_plain(x, u, c).reshape(-1) for x, u, c, _ in inputs])

    for name, fn in zip(names, (telemetry.accumulate_plain, d1_plain, r1_plain)):
        setattr(telemetry_kernel, name, fn)
    try:
        yield
    finally:
        for name, fn in zip(names, saved):
            setattr(telemetry_kernel, name, fn)


def fleet_twin(dev, plain: bool) -> dict:
    """FLEET_TWIN_B replicas of the scored grid at full width, telemetry on:
    a detection run of FLEET_TWIN_TICKS ticks checked every 2 (L1, L2, S1,
    T1, P1) and a fetch (D1, R1), on the kernels or on their plain versions
    (on the card).  Returns the ticks, the leaves and the records."""
    plan, meta, seeds = fleet_grid(dev, FLEET_N)
    plan = chaos.slice_plan(plan, 1, 1 + FLEET_TWIN_B)
    mc = montecarlo.MonteCarlo(lifecycle.LifecycleParams(n=FLEET_N, k=FLEET_K), seeds[1:1 + FLEET_TWIN_B],
                               telemetry=True, device=dev)
    with contextlib.ExitStack() as stack:
        if plain:
            for ctx in (plain_lifecycle(), plain_threefry(), plain_telemetry()):
                stack.enter_context(ctx)
        ticks, det = mc.run_until_detected(fleet_victims(FLEET_N), plan, max_ticks=FLEET_TWIN_TICKS, check_every=2)
        records = mc.fetch_telemetry(plan)
    return {"ticks": ticks.tolist(), "detected": det.tolist(), "records": records,
            "leaves": lifecycle.state_to_numpy(mc.states)}


def fleet_block_profile(mc, faults, ticks: int) -> dict:
    """``ticks`` fleet ticks (``mc.run``) timed alone (CUDA events), then
    ``ticks`` more under ``torch.profiler``: the window, the wrappers'
    launches and the profiler's kernel launches a fleet tick, and the
    device's busy share (the profiler's own cost, ~17k records a fleet
    tick at B = 32, lengthens its window)."""
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    mc.run(ticks, faults)
    end.record()
    torch.cuda.synchronize()
    alone_ms = start.elapsed_time(end)
    reset_fleet_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiler_warmup()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        mc.run(ticks, faults)
        end.record()
        torch.cuda.synchronize()
    port = fleet_launches()
    window_ms = start.elapsed_time(end)
    launches, busy = 0, 0.0
    for evt in prof.key_averages():
        if (evt.device_type == torch.autograd.DeviceType.CUDA and evt.key not in lifecycle.PHASES
                and MARK_TAG not in evt.key and evt.self_device_time_total > 0 and "(" in evt.key):
            launches += evt.count
            busy += evt.self_device_time_total / 1e3
    return {"b": mc.n_replicas, "ticks": ticks, "ms_a_fleet_tick": alone_ms / ticks, "profiled_window_ms": window_ms,
            "launches_a_fleet_tick": launches / ticks, "port_launches_a_fleet_tick": {
                key: v / ticks for key, v in port.items()},
            "port_launches_a_replica_tick": sum(port.values()) / ticks / mc.n_replicas,
            "busy_ms": busy, "busy_share": busy / window_ms}


def timed(fn):
    """(fn's result, wall seconds to a synchronize, the fleet path's wrapper
    launches): the counts are set to 0 just before and read just after."""
    reset_fleet_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, fleet_launches()


def run_fleet(dev: torch.device) -> dict:
    """Phase 15 on ``dev``; returns its timings and launches by path under
    ``"fleet"``.  15: the twin (every kernel of the fleet path against its plain
    version on the fleet's shapes); a) simbench ``montecarlo`` at full
    scale, its distribution and 32 digests == the JAX pins, and a profiled
    fleet block at B = 1 and B = 32; b) ``mc_churn``: the curve, cliff and
    contrasts == the pins; c) the scored sweep saved at tick 128 and
    restored: both runs' scores and digests == each other and the pins."""
    kern, plain = fleet_twin(dev, False), fleet_twin(dev, True)
    check(kern["ticks"] == plain["ticks"] and kern["detected"] == plain["detected"],
          f"fleet twin: detection {kern['ticks']} on the kernels == {plain['ticks']} on the plain versions")
    for name in lifecycle.LifecycleState._fields:
        check(np.array_equal(getattr(kern["leaves"], name), getattr(plain["leaves"], name)),
              f"fleet twin: {name} on the kernels == on the plain versions")
    check(records_match(kern["records"], plain["records"]),
          f"fleet twin: the records on the kernels == on the plain versions: "
          f"{record_diff(kern['records'], plain['records'])}")
    log(f"phase15: twin of {FLEET_TWIN_B} replicas x {FLEET_TWIN_TICKS} ticks at {FLEET_N} x {FLEET_K} with "
        f"telemetry: L1, L2, S1, T1, P1, D1, R1 == plain (every leaf, every record)")
    out = {}
    (mc_res, mc), wall, launches = timed(lambda: fleet_mc_run(dev))
    check(mc_res["distribution"] == PIN_FLEET_MC["distribution"],
          f"15a: the distribution == the JAX pin: {mc_res['distribution']}")
    check(mc_res["digests"] == PIN_FLEET_MC["digests"], "15a: the 32 final digests == the JAX pins")
    check(all(launches[key] > 0 for key in FLEET_KERNELS[:4]), f"15a: L1, L2, S1 and T1 launched: {launches}")
    log(f"phase15a: montecarlo {FLEET_N} x {FLEET_K} x B {FLEET_B}: ticks_all {mc_res['distribution']['ticks_all']} "
        f"and 32 digests == JAX; wall {wall:.3f} s (host clock to a synchronize); launches {launches}")
    out["15a"] = {"wall_s": wall, "launches": launches, "ticks_max": mc_res["distribution"]["ticks_max"]}
    del mc
    # launches and busy share of a fleet tick, from the 15a recipe's state after 8 ticks
    victims, faults = fleet_faults(dev, FLEET_N)
    blocks = {}
    for b in (1, FLEET_B):
        mc = montecarlo.MonteCarlo(lifecycle.LifecycleParams(n=FLEET_N, k=FLEET_K), range(FLEET_SEED, FLEET_SEED + b),
                                   device=dev)
        mc.run(8, faults)
        torch.cuda.synchronize()
        blocks[f"b{b}"] = fleet_block_profile(mc, faults, FLEET_PROFILE_TICKS)
        del mc
    log(f"phase15a: a fleet tick at B = 1: {blocks['b1']}; at B = {FLEET_B}: {blocks[f'b{FLEET_B}']}")
    out["profile"] = blocks
    churn, wall, launches = timed(lambda: fleet_churn_run(dev))
    for key in ("churn_ticks", "churn_cliff_at", "cliff_jump_ticks", "cliff_contrast"):
        check(churn[key] == PIN_FLEET_CHURN[key], f"15b: {key} {churn[key]} == the JAX pin")
    log(f"phase15b: mc_churn: curve, cliff at {churn['churn_cliff_at']} (jump {churn['cliff_jump_ticks']}) and "
        f"contrasts {churn['cliff_contrast']} == JAX; wall {wall:.3f} s; launches {launches}")
    if wall > 150:
        log(f"phase15b: the lockstep study took {wall:.1f} s, past the 150 s it was expected to take")
    out["15b"] = {"wall_s": wall, "launches": launches, "cliff_at": churn["churn_cliff_at"]}
    ckpt = OUT_DIR / "phase15_fleet_ckpt"
    OUT_DIR.mkdir(exist_ok=True)
    scored, wall, launches = timed(lambda: fleet_scored_run(dev, str(ckpt)))
    check(scored["scores"] == PIN_FLEET_SCORED["scores"], f"15c: scores == the JAX pins: {scored['scores']}")
    check(scored["digests"] == PIN_FLEET_SCORED["digests"], f"15c: digests == the JAX pins: {scored['digests']}")
    check(scored["resumed_scores"] == scored["scores"] and scored["resumed_digests"] == scored["digests"]
          and scored["resumed_from"] == FLEET_SAVE_AT,
          f"15c: the run restored from tick {scored['resumed_from']} == the unbroken run")
    check(all(launches[key] > 0 for key in FLEET_KERNELS[1:]), f"15c: L2, S1, T1, P1, D1 and R1 launched: {launches}")
    log(f"phase15c: scored sweep of {len(scored['scores'])} scenarios x {FLEET_HORIZON} ticks, saved at "
        f"{FLEET_SAVE_AT} and restored: scores and digests == each other and JAX; wall {wall:.3f} s (two runs, "
        f"the second from tick {FLEET_SAVE_AT}); launches {launches}")
    out["15c"] = {"wall_s": wall, "launches": launches}
    return {"fleet": out}


# phase 16: the serve tier's collector and transports.  16a simbench
# serve_ring at full scale (cli/simbench.py:1657-1659), 16b the same A/B over
# TCP with the json codec at simbench's non-full settings (:1660-1662), 16c
# the collector at BASELINE config 5's ring (phase 2-3's 4096 x 256 tokens)
SERVE_AB_FULL = dict(n_servers=64, replica_points=100, frontends=4, batch=8192, batches_per_rep=16, reps=5,
                     warm_reps=1, latency_reqs=300, transport="shm", seed=0)
SERVE_AB_TCP = dict(n_servers=64, replica_points=100, frontends=4, batch=4096, batches_per_rep=8, reps=3,
                    warm_reps=1, latency_reqs=150, transport="tcp", codec="json", seed=0)
SERVE_SUBMIT, SERVE_N3_KEYS = 8192, 1024  # 16c: 128 submits of 8192 keys; an n = 3 group every 8
SERVE_MAX_BATCH = SERVE_INLINE_MAX = 65536  # run_ab's collector settings
SERVE_FIELDS = {"keys_per_flush", "queue_wait_us", "dispatch_us", "flushes", "requests", "keys", "gen"}


def serve_ab(dev: torch.device, kw: dict, what: str) -> dict:
    """One ``run_ab`` leg with a journal; its certificate (scripts/serve_smoke.py's),
    and the journal's ``serve`` and ``ring_update`` records."""
    from ringpop_tpu_torch.serve.bench import run_ab

    OUT_DIR.mkdir(exist_ok=True)
    path = OUT_DIR / f"phase16_{what}.jsonl"
    journal = telemetry.TelemetryJournal(str(path))
    journal.header("serve", "serve_ring", {"seed": kw["seed"], "transport": kw["transport"]})
    try:
        t0 = time.perf_counter()
        rec = run_ab(journal=journal, device=dev, **kw)
        wall = time.perf_counter() - t0
    finally:
        journal.close()
    records = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    serves = [r for r in records if r.get("kind") == "serve"]
    updates = [r for r in records if r.get("kind") == "ring_update"]
    check(rec["digest_equal"], f"{what}: serve and bisect owner digests are equal per (worker, rep)")
    check(rec["generation_pinned"], f"{what}: every answer carries the pinned generation: {rec['generations_seen']}")
    check(rec["update_certified"], f"{what}: the live update re-certifies against the post-update oracle")
    check(rec["latency_b1"]["owners_match_oracle"], f"{what}: the B = 1 answers equal the bisect oracle")
    check(bool(serves) and all(SERVE_FIELDS <= set(r) and {"mean", "p50", "p90", "max"} <= set(r["keys_per_flush"])
                               for r in serves), f"{what}: the journal's serve records carry serve_smoke's fields")
    check(bool(updates) and updates[-1]["gen"] == rec["update_record"]["gen"],
          f"{what}: the last ring_update record's gen == the committed generation {rec['update_record']['gen']}")
    keep = ("serve_qps_median", "bisect_qps_median", "speedup_median", "serve_qps_reps", "bisect_qps_reps",
            "ratio_reps", "latency_b1", "telemetry", "flush_us", "codec")
    out = {k: rec[k] for k in keep}
    out.update(wall_s=wall, serve_records=len(serves))
    log(f"phase{what}: run_ab {kw['transport']} ({kw['n_servers']} servers, {kw['frontends']} frontends, "
        f"batch {kw['batch']} x {kw['batches_per_rep']}, {kw['reps']} reps): digests equal, generation pinned, "
        f"update certified, B = 1 owners == oracle; {json.dumps(out)}")
    return out


def serve_collector_run(dev: torch.device, n_servers: int, replicas: int, submits: int, seed: int = SEED):
    """16c: a ``RingService`` on its own loop over a ``RingStore`` of
    ``n_servers`` x ``replicas`` tokens on ``dev``, fed ``submits`` requests
    of SERVE_SUBMIT keys with an n = 3 group of SERVE_N3_KEYS every 8, in
    the same flushes; halfway a 1 % churn commit runs on another thread
    while requests are pending and flushes go on, and after it one more
    round.  Every answer carries generation 0 or 1 and equals the host
    oracles (searchsorted, ``host_lookup_n``) of that generation's ring.
    Returns the run's record and the service."""
    import asyncio
    import threading

    from ringpop_tpu_torch.serve.service import RingService

    servers = [f"10.0.{i // 256}.{i % 256}:3000" for i in range(n_servers)]
    t0 = time.perf_counter()
    store = RingStore(servers, replica_points=replicas, device=dev)
    build_s = time.perf_counter() - t0
    svc = RingService(store, max_batch=SERVE_MAX_BATCH, flush_us=0.0, inline_resolve_max=SERVE_INLINE_MAX)
    rng = np.random.default_rng(seed + 16)
    hashes = rng.integers(0, 2**32, size=submits * SERVE_SUBMIT, dtype=np.uint32)
    n3 = rng.integers(0, 2**32, size=SERVE_N3_KEYS, dtype=np.uint32)
    hosts = {0: store.snapshot_host()}
    n_churn = max(1, n_servers // 100)
    commit = threading.Thread(target=lambda: store.update(
        add=[f"10.9.{i // 256}.{i % 256}:3000" for i in range(n_churn)], remove=servers[:n_churn]))
    asked = []  # (hashes, n, future)

    async def drive():
        def submit(h, n=1):
            asked.append((h, n, svc.submit(h, n=n)))

        for i in range(submits):
            if i == submits // 2:
                commit.start()
            submit(hashes[i * SERVE_SUBMIT:(i + 1) * SERVE_SUBMIT])
            if i % 8 == 7:
                submit(n3, 3)
            if commit.is_alive():
                await asyncio.sleep(0)  # let flushes run while the commit is in flight
        commit.join()
        submit(hashes[:SERVE_SUBMIT])
        submit(n3, 3)
        return await asyncio.gather(*(f for _, _, f in asked))

    t0 = time.perf_counter()
    answers = asyncio.run(drive())
    wall = time.perf_counter() - t0
    hosts[1] = store.snapshot_host()
    gens = {}
    for (h, n, _), (owners, gen) in zip(asked, answers):
        check(gen in (0, 1), f"16c: every answer carries generation 0 or 1, saw {gen}")
        ht, ho, _, ns = hosts[gen]
        want = host_owner(ht, ho, h) if n == 1 else host_lookup_n(ht, ho, h, n, ns)
        check(np.array_equal(np.asarray(owners), want), f"16c: owners of a request of {len(h)} keys (n = {n}) == "
              f"the host oracle of generation {gen}")
        gens[gen] = gens.get(gen, 0) + 1
    check(set(gens) == {0, 1}, f"16c: answers of both generations, around the commit: {gens}")
    check(store.servers_at(1) is not None and store.gen == 1, "16c: the churn commit is generation 1")
    t = svc.telemetry
    keys = sum(len(h) for h, _, _ in asked)
    check(t.keys_total == keys and t.requests_total == len(asked),
          f"16c: the collector took every key ({t.keys_total} of {keys}) and request")
    return {"servers": n_servers, "tokens": n_servers * replicas, "capacity": store.capacity, "requests": len(asked),
            "keys": keys, "answers_by_gen": gens, "flushes": t.flushes_total,
            "keys_per_flush_mean": t.keys_total / max(t.flushes_total, 1), "wall_s": wall,
            "store_build_s": build_s}, svc


def serve_flush_profile(svc, size: int, n: int = 1) -> dict:
    """One flush of ``size`` keys through the collector (``submit_nowait`` +
    ``flush_now``, resolved inline) under ``torch.profiler``: the kernels it
    launches and their device time, with the flush's host wall."""
    import asyncio

    from torch.profiler import ProfilerActivity, profile

    keys = np.random.default_rng(size).integers(0, 2**32, size=size, dtype=np.uint32)
    got = []

    async def one():
        svc.submit_nowait(keys, n, lambda rows, gen: got.append(gen))
        svc.flush_now()

    asyncio.run(one())  # warm this shape
    for _ in range(3):
        got.clear()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiler_warmup()
            t0 = time.perf_counter()
            asyncio.run(one())
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
        kernels, marks, busy = {}, 0, 0.0
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA or evt.self_device_time_total <= 0 or "(" not in evt.key:
                continue
            if MARK_TAG in evt.key:
                marks += evt.count
            else:
                kernels[evt.key[:80]] = evt.count
                busy += evt.self_device_time_total / 1e3
        # the profiler drops the first records of a session: a mark that
        # survived means the drop ended before the flush, whose upload and
        # read-back copies bracket its kernels
        copies = [k for k in kernels if k.startswith("Memcpy")]
        if got and marks > 0 and any("HtoD" in k for k in copies) and any("DtoH" in k for k in copies):
            return {"keys": size, "n": n, "launches": sum(kernels.values()), "device_ms": busy,
                    "flush_wall_ms": wall * 1e3, "marks": marks, "kernels": kernels}
        log(f"16: the profiler recorded {marks} of {WARMUP_MARKS} marks and the copies {copies}; "
            "profiling the flush again")
    raise SystemExit("chip_smoke FAILED: the profiler lost the records of the serve flush three times")


def run_serve(dev: torch.device) -> dict:
    """Phase 16 on ``dev``: 16a, 16b and 16c (above); the launches of one
    profiled flush at 8192 and 65536 keys.  The serve path runs no
    hand-written kernel (the fused lookup is searchsorted and a gather, as
    in the JAX package), so no wrapper counts here."""
    out = {"16a": serve_ab(dev, SERVE_AB_FULL, "16a"), "16b": serve_ab(dev, SERVE_AB_TCP, "16b")}
    c, svc = serve_collector_run(dev, N_SERVERS, REPLICAS, N_KEYS // SERVE_SUBMIT)
    log(f"phase16c: RingService over the {c['tokens']}-token ring (capacity {c['capacity']}): {c['keys']} keys in "
        f"{c['requests']} requests ({N_KEYS // SERVE_SUBMIT} of {SERVE_SUBMIT}, n = 3 groups of {SERVE_N3_KEYS}), a "
        f"1 % churn commit in flight: owners == the host oracles of each answer's generation {c['answers_by_gen']}; "
        f"{c['flushes']} flushes, {c['keys_per_flush_mean']:.1f} keys a flush, wall {c['wall_s']:.3f} s "
        f"(ring built in {c['store_build_s']:.1f} s)")
    out["16c"] = c
    out["flush_profile"] = {str(size): serve_flush_profile(svc, size) for size in (SERVE_SUBMIT, SERVE_MAX_BATCH)}
    out["flush_profile"]["n3_1024"] = serve_flush_profile(svc, SERVE_N3_KEYS, 3)
    for key, rec in out["flush_profile"].items():
        log(f"phase16: one flush of {rec['keys']} keys (n = {rec['n']}): {rec['launches']} launches, "
            f"{rec['device_ms']:.4f} ms of device, {rec['flush_wall_ms']:.3f} ms of host wall; {rec['kernels']}")
    return {"serve": out}


# -- phase 17: the SWIM engines sharded over node ranks (parallel/) -------------

SHARD_RANKS = 4
# simbench's sharded100k (ringpop_tpu/cli/simbench.py:300-430), at its CLI seed
SH100K_N, SH100K_K, SH100K_TICKS, SH100K_VICTIMS, SH100K_SEED = 100_000, 256, 6, 100, 0
SH100K_BLOCK_TICKS, SH100K_MAX_BLOCKS = 32, 16
SHARD_DEADLINE_S = 600

# -- phase 18: the rumor axis (word-sharded planes on (P, R) meshes) --
RUMOR_SHAPE = (4, 2)  # simbench's own mesh for sharded100k and the chaos twins (devs.reshape(4, 2))
RUMOR_HEADLINE_SHAPE = (2, 2)  # the headline and the delta at full width on a rumor-sharded mesh
# simbench's _chaos_sharded_twin (cli/simbench.py:1557-1610): 4096 x 64, suspect_ticks 6, 24 ticks,
# horizon 64, counter, seed 0; its four plans (churn100k, flap1k, asym_partition, topo_chaos)
TWIN_N, TWIN_K, TWIN_TICKS, TWIN_HORIZON, TWIN_SUSPECT_TICKS, TWIN_SEED = 4096, 64, 24, 64, 6, 0
TWIN_PLANS = (("churn", "chaos"), ("flap", "chaos"), ("asym", "chaos"), ("smoke", "topo"))
# pinned from the JAX package (ringpop_tpu.sim.lifecycle, .chaos, .topology) run unsharded on the CPU;
# tests/test_torch_rumor_axis_chaos.py recomputes them
PIN_CHAOS_TWIN = {  # each twin plan after TWIN_TICKS ticks: tree_digest and every leaf's sha256
    "churn": {"digest": 3759649303, "leaves": {
        "r_subject": "7cde0d6ee7feae75c099e0e84479adf6bfc7fcfb2c979852084f3102b4ce26ca",
        "r_inc": "909083e5fba17a93db05b75674edb904baba5ab944734ff345eb8f49b10c7a48",
        "r_status": "6f65a6c57b40c2c49ed678a66651f7be99a070423c24fcbb5456ab3dd128b442",
        "r_deadline": "afb72b91b887072333e39d4cb4ac51bd3dcc393c79fff512eaf52ed4025185a6",
        "learned": "ef0abdda2fc4e1b88dac4cb67a9c36230d07d2033099adef8737ab56aba274c0",
        "pcount": "27fed56edde0638592f764f680474d135a505bb60870ac755afe352c66a5f641",
        "ride_ok": "2d864c0b789a43214eee8524d3182075125e5ca2cd527f3582ec87ffd94076bc",
        "base_status": "0b4a295fcf49865fe114d58e46f8a5f634caed09d0f4bfffb2e721af9fea6f14",
        "base_inc": "4fe7b59af6de3b665b67788cc2f99892ab827efae3a467342b3bb4e3bc8e5bfe",
        "base_present": "3431383721510cf1c211de027cf958c183e16db5fabb6b230eb284c85e196aa9",
        "base_pending": "eeecfb0d7a311474ab28edadad682b4efa45d13ee5faa47cb0e4f62eceafcd32",
        "base_deadline": "942679b524d9ba976d681a4991cfed3c5ba83934beec2f4b191ff10b781224e5",
        "self_inc": "a4e2a80093091e23de13b47d14b357feeed92caec1f9df846e13193b02e4870d",
        "tick": "17fa9c7f5e9039a2d46e73e17d8e094a796ee4c313199bad42db4ee1dc30d865",
        "key": "af5570f5a1810b7af78caf4bc70a660f0df51e42baf91d4de5b2328de0e83dfc",
    }},
    "flap": {"digest": 1785704893, "leaves": {
        "r_subject": "aceb6f74b841d22c9da3185f4163efbc244b33df3115ec148c79425b0b2a0d53",
        "r_inc": "8d0c0fbb46f2dd758022c4d26d4ab8d3927548adb573aff50ba65cfb4619b7b0",
        "r_status": "66e75a142b4d24ee83d1fe88231c9e4c49fb04ce8fde41e529dabe2b68ecbdfb",
        "r_deadline": "86fd95ba7617ab5745bf50410d0f63abf0fec35980e11fc8459484c966f202e7",
        "learned": "89ab276c873b0cbf3bdc6790031af9183e74ad6307785d35475470ef11ecfcd0",
        "pcount": "ab89e5c18b7b40fbf441e82c366ecea56883dae600cd9d3f96f5c08ac335c94a",
        "ride_ok": "2d864c0b789a43214eee8524d3182075125e5ca2cd527f3582ec87ffd94076bc",
        "base_status": "c25e3e5c628e17dc68aea173877d4e30496e1cc1c1e585f07c6c792ba9a66c76",
        "base_inc": "1bdfa06973c24ca55dec18f84bbc6471d64fc94736fd5f39430b2b5b1d8f554e",
        "base_present": "3431383721510cf1c211de027cf958c183e16db5fabb6b230eb284c85e196aa9",
        "base_pending": "d76ca13c222ba1eb566ff65c566cf14c677cb888d68c2610ca813a7ff98771ad",
        "base_deadline": "0b9b3314c6246a4bf3c1fc85d719cf6d6602a27f026d1cce8d971b7cd42b62ca",
        "self_inc": "c6bd80e25e12ec0891cd1358cc86031c4b395e6e174c498cc7cac0e3462003c3",
        "tick": "17fa9c7f5e9039a2d46e73e17d8e094a796ee4c313199bad42db4ee1dc30d865",
        "key": "af5570f5a1810b7af78caf4bc70a660f0df51e42baf91d4de5b2328de0e83dfc",
    }},
    "asym": {"digest": 4163614190, "leaves": {
        "r_subject": "8787a7d4ba45f7e67616e207e35ff4e16a598850cbba0c74babd0aeb4c90bd17",
        "r_inc": "350e3dff9f9b65500ee1d9020941a9fe519f674df221faa553c38eb44409bd81",
        "r_status": "8451adc36dbec35baf8e7bcda1939ed816102c91a3524fc19f85ada17cba1b27",
        "r_deadline": "cfbabb1957a30f3a47b28d160aa0c7410d40e8f8a1d4dab8b683cdd4120157a9",
        "learned": "49c54b706c03454b64c32011d9487a6cc174bb0b6e5bf1dae997369d39ea9743",
        "pcount": "9204db97e8ed0751be8a6d4ac2b62b0c5f5420e755fd45a0a2f17b2ced1bab2d",
        "ride_ok": "2d864c0b789a43214eee8524d3182075125e5ca2cd527f3582ec87ffd94076bc",
        "base_status": "1abcecd7e688784c7a366974d6e86d637ee5f008c7bffe59ec492fbd6e7370a6",
        "base_inc": "4fe7b59af6de3b665b67788cc2f99892ab827efae3a467342b3bb4e3bc8e5bfe",
        "base_present": "3431383721510cf1c211de027cf958c183e16db5fabb6b230eb284c85e196aa9",
        "base_pending": "facab2846fe32d368d9783f18b18d1c325407943154b4428760e2f601de2109a",
        "base_deadline": "a199c38190102f5ee2ae0c89a9e811181dc94284f489d784341c7116289cfa7c",
        "self_inc": "47d4e647011e2b48164aa1fc59372355df1b089d815498dffab348e9f2d02d6b",
        "tick": "17fa9c7f5e9039a2d46e73e17d8e094a796ee4c313199bad42db4ee1dc30d865",
        "key": "af5570f5a1810b7af78caf4bc70a660f0df51e42baf91d4de5b2328de0e83dfc",
    }},
    "smoke": {"digest": 2078675485, "leaves": {
        "r_subject": "b7f9bdd5bf533c94fc2d7672f90801a9324ad8ccd91ab5840f655886a1c85a42",
        "r_inc": "de76bd288874c3d06041c6e4a4eceadb2f27c7dff983c9c51d1e254e15557915",
        "r_status": "b64bf18d187450dfda3390499413684c1e0b5df3b6fd85fdcde932beaa587423",
        "r_deadline": "008e6a6f401915b6dc57988e62704ac6635b1144c82ee4b35a07e2412588d052",
        "learned": "38f4349b8ae96fbb19aeba1b06c833249a9c7ab3d655ae82016818bd4ea3ce61",
        "pcount": "49ce18372c569a38c86348445c51329df8e131fc36a9216cd3b6386e71ffcda4",
        "ride_ok": "2d864c0b789a43214eee8524d3182075125e5ca2cd527f3582ec87ffd94076bc",
        "base_status": "94f973012af0d3b089dd51b15b1715319f1a2add9a6154b5fcad88f50bea6f18",
        "base_inc": "4fe7b59af6de3b665b67788cc2f99892ab827efae3a467342b3bb4e3bc8e5bfe",
        "base_present": "3431383721510cf1c211de027cf958c183e16db5fabb6b230eb284c85e196aa9",
        "base_pending": "648788974252983ad2631412fea7992bba67056290af42980ac5083881747157",
        "base_deadline": "15986cdff4719d4717551e87d042de088466087385bbb09eca5e234482797081",
        "self_inc": "178e2bfc418242dd6257b4acc01e0972738aa74ff2a1b4a24abf98a88e5374bb",
        "tick": "17fa9c7f5e9039a2d46e73e17d8e094a796ee4c313199bad42db4ee1dc30d865",
        "key": "af5570f5a1810b7af78caf4bc70a660f0df51e42baf91d4de5b2328de0e83dfc",
    }},
}
# the kernels a sharded tick runs, by their wrappers' launch-count names
SHARD_KERNELS = {"row_reduce": "packbits_row_reduce", "popcount_rows": "packbits_popcount_rows",
                 "slot_walk": "lifecycle_slot_walk", "first_live_learner": "lifecycle_first_live_learner",
                 "state_digest": "telemetry_state_digest"}


def shard_reset() -> None:
    packbits_kernel.reset_launches()
    lifecycle_kernel.reset_launches()
    telemetry_kernel.reset_launches()


def shard_launches() -> dict[str, int]:
    counts = {**packbits_kernel.launches, **lifecycle_kernel.launches,
              "state_digest": telemetry_kernel.launches["state_digest"]}
    return {name: counts[name] for name in SHARD_KERNELS}


def gathered_digests(leaves, module) -> dict[str, str]:
    """sha256 of each leaf gathered from the ranks (numpy of the port's
    dtypes), in the JAX package's dtypes."""
    cls = module.LifecycleState if module is lifecycle else module.DeltaState
    state = cls(*(torch.from_numpy(np.ascontiguousarray(x)) for x in leaves))
    return leaf_digests(module.state_to_numpy(state), cls._fields)


def sh100k_config(dev: torch.device):
    """sharded100k's configuration: 100,000 x 256, counter stream,
    suspect_ticks 10, 100 victims down."""
    victims = np.sort(np.random.default_rng(SH100K_SEED).choice(SH100K_N, size=SH100K_VICTIMS, replace=False))
    up = np.ones(SH100K_N, bool)
    up[victims] = False
    params = lifecycle.LifecycleParams(n=SH100K_N, k=SH100K_K, suspect_ticks=10, rng="counter")
    return params, victims, delta.DeltaFaults(up=torch.from_numpy(up).to(dev))


def event_timed(fn):
    """(fn(), ms) by CUDA events around it."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def exchange_record(mesh, ticks: int) -> dict:
    """The exchange's sends and bytes since the last reset, per tick: the
    shift legs' sends (and each leg's count), every collective's bytes, and
    the bytes staged through host memory for gloo."""
    from ringpop_tpu_torch.parallel import shift

    def per_tick(stats: dict) -> dict:
        return {"sends_per_tick": stats["sends"] / ticks, "send_bytes_per_tick": stats["send_bytes"] / ticks,
                "collectives_per_tick": stats["collectives"] / ticks,
                "collective_bytes_per_tick": stats["collective_bytes"] / ticks,
                "staged_bytes_per_tick": stats["staged_bytes"] / ticks,
                "bytes_per_tick": (stats["send_bytes"] + stats["collective_bytes"]) / ticks}

    legs = list(shift.leg_sends)
    return {"legs": len(legs), "sends_per_leg": sorted(set(legs)), **per_tick(mesh.stats),
            "by_axis": {axis: per_tick(stats) for axis, stats in mesh.axis_stats.items()}}


def shard_stats_reset(mesh) -> None:
    """Zero the exchange's counters, after every rank has reached this
    point: a timed region then starts on all ranks together (rank 0's
    extra host work before it, the gathered digests, is not timed)."""
    import torch.distributed as dist

    from ringpop_tpu_torch.parallel import shift

    torch.cuda.synchronize()
    dist.barrier(group=mesh.group, device_ids=[mesh.device.index] if mesh.transport == "nccl" else None)
    mesh.reset_stats()
    shift.reset_stats()


def sharded_100k(mesh) -> dict:
    """17a on this rank: sharded100k's 6 ticks, then its detect path (blocks
    of 32 ticks, at most 16) with the node-sharded walk hint, gathered."""
    from ringpop_tpu_torch.parallel import partition
    from ringpop_tpu_torch.parallel.mesh import with_exchange_mesh

    params, victims, faults = sh100k_config(mesh.device)
    sp = with_exchange_mesh(params, mesh)
    lifecycle._run_block(sp, lifecycle.init_state(sp, seed=SH100K_SEED), faults, 1)  # warm-up, not timed
    state = lifecycle.init_state(sp, seed=SH100K_SEED)
    shard_reset()
    shard_stats_reset(mesh)
    state, ms = event_timed(lambda: lifecycle._run_block(sp, state, faults, SH100K_TICKS))
    out = {"tick_ms": ms / SH100K_TICKS, "launches": shard_launches(), "exchange": exchange_record(mesh, SH100K_TICKS)}
    leaves = partition.host_gather(state, mesh)
    out["digests"] = gathered_digests(leaves, lifecycle) if mesh.rank == 0 else None
    hint = partition.NamedSharding(mesh, partition.P("node", None))
    subjects = torch.as_tensor(victims, device=mesh.device)
    shard_stats_reset(mesh)
    (state, blocks, done), ms = event_timed(lambda: lifecycle._run_until_detected_device(
        sp, lifecycle.init_state(sp, seed=SH100K_SEED), faults, subjects, min_status=FAULTY,
        block_ticks=SH100K_BLOCK_TICKS, max_blocks=SH100K_MAX_BLOCKS, learned_sharding=hint))
    leaves = partition.host_gather(state, mesh)
    out["detect"] = {"blocks": blocks, "done": bool(done), "ms": ms,
                     "digests": gathered_digests(leaves, lifecycle) if mesh.rank == 0 else None}
    return out


def sharded_headline(mesh) -> dict:
    """17b on this rank: the headline at the counter stream over the mesh —
    the first 8 ticks, L1 on this rank's block held to its plain version on
    that state, then ``LifecycleSim`` detection and convergence with the
    view checksums and the combined partial-sum digest (the main path:
    counts 0 before it, read after)."""
    from ringpop_tpu_torch.parallel import partition
    from ringpop_tpu_torch.parallel.mesh import with_exchange_mesh

    n, k = LIFE_N, LIFE_K
    victims, faults = headline_faults(mesh.device, n)
    params = with_exchange_mesh(lifecycle.LifecycleParams(n=n, k=k, rng="counter", exchange="shift"), mesh)
    twin = lifecycle._run_block(params, lifecycle.init_state(params, seed=LIFE_SEED), faults, LIFE_TWIN_TICKS)
    leaves = partition.host_gather(twin, mesh)
    out = {"twin_digests": gathered_digests(leaves, lifecycle) if mesh.rank == 0 else None}
    out["l1_block"] = l1_block_check(twin, mesh, victims, faults)
    del twin, leaves
    sim = lifecycle.LifecycleSim(n=n, k=k, seed=LIFE_SEED, rng="counter", exchange_mesh=mesh)
    hint = partition.NamedSharding(mesh, partition.P("node", None))
    torch.cuda.synchronize()
    shard_reset()
    shard_stats_reset(mesh)
    (ticks, ok), detect_ms = event_timed(lambda: sim.run_until_detected(
        victims, faults, max_ticks=LIFE_MAX_TICKS, check_every=LIFE_CHECK_EVERY, blocks_per_dispatch=8,
        learned_sharding=hint))
    exchange = exchange_record(mesh, max(ticks, 1))
    (cticks, cok), converge_ms = event_timed(lambda: sim.run_until_converged(
        faults, max_ticks=LIFE_MAX_TICKS, check_every=LIFE_CHECK_EVERY, blocks_per_dispatch=8))
    cs = lifecycle.view_checksums(sim.state, faults, mesh)
    digest = int(telemetry.tree_digest(sim.state, mesh))
    torch.cuda.synchronize()
    out.update({"launches": shard_launches(), "detect_ticks": ticks, "detected": ok, "converge_ticks": cticks,
                "converged": cok, "detect_ms": detect_ms, "converge_ms": converge_ms,
                "tick_ms": detect_ms / max(ticks, 1), "exchange": exchange, "digest": digest})
    cs_np = partition.host_gather(cs, mesh, spec=partition.P("node"))
    leaves = partition.host_gather(sim.state, mesh)
    if mesh.rank == 0:
        out["views_sum"] = int(cs_np.sum()) % 2**32
        out["views_sha"] = hashlib.sha256(cs_np.astype("<u4").tobytes()).hexdigest()
        out["digests"] = gathered_digests(leaves, lifecycle)
        whole = lifecycle.LifecycleState(*(torch.from_numpy(np.ascontiguousarray(x)).to(mesh.device)
                                           for x in leaves))
        out["whole_digest"] = int(telemetry.tree_digest(whole))
    return out


def l1_block_check(state, mesh, victims, faults) -> dict:
    """L1 takes a node rank's block (its rows walked, subjects global): on
    this rank's block of a state with slots in flight, both modes ==
    their plain versions."""
    n = state.learned.shape[0] * mesh.size
    lo, hi = mesh.block(n)
    whole = lifecycle._whole_word_rows(state, mesh)  # the rank's rows, every word (a rumor-axis gather)
    rows = whole.learned
    base_key = lifecycle._base_key(whole)
    order, ss, sk = lifecycle_kernel.walk_order(state.r_subject, lifecycle._rkey(state), n)
    subjects = torch.as_tensor(victims, device=state.learned.device)
    obs = lifecycle._observers(whole, subjects, faults, n)[lo:hi].contiguous()
    got = lifecycle_kernel.slot_walk_cuda(rows, order, ss, sk, base_key, "detect", obs, FAULTY)
    want = lifecycle_kernel.slot_walk_plain(rows, order, ss, sk, base_key, "detect", obs, FAULTY)
    sums = lifecycle_kernel.slot_walk_cuda(rows, order, ss, sk, base_key, "checksum")
    sums_plain = lifecycle_kernel.slot_walk_plain(rows, order, ss, sk, base_key, "checksum")
    return {"rows": hi - lo, "slots": int((state.r_subject >= 0).sum()), "detect_equal": bool(torch.equal(got, want)),
            "checksum_equal": bool(torch.equal(sums, sums_plain)),
            "max_abs_err": int((sums - sums_plain).abs().max()) if sums.numel() else 0}


def sharded_delta(mesh) -> dict:
    """17c on this rank: the delta engine at 1M x 128 (shift, counter) over
    the mesh, ``run_until_converged`` (the main path), gathered."""
    from ringpop_tpu_torch.parallel import partition
    from ringpop_tpu_torch.parallel.mesh import with_exchange_mesh

    params = with_exchange_mesh(delta.DeltaParams(n=DELTA_N, k=DELTA_K, exchange="shift", rng="counter"), mesh)
    state = delta.init_state(params, seed=DELTA_SEED)
    shard_reset()
    shard_stats_reset(mesh)
    (state, ticks, ok), ms = event_timed(lambda: delta.run_until_converged(
        params, state, max_ticks=DELTA_MAX_TICKS, check_every=DELTA_CHECK_EVERY))
    exchange = exchange_record(mesh, max(ticks, 1))
    fraction = float(delta.converged_fraction(state, mesh=mesh))  # S2, on the main path as in phase 6
    out = {"ticks": ticks, "converged": ok, "ms": ms, "tick_ms": ms / max(ticks, 1), "launches": shard_launches(),
           "exchange": exchange, "fraction": fraction}
    leaves = partition.host_gather(state, mesh)
    out["digests"] = gathered_digests(leaves, delta) if mesh.rank == 0 else None
    return out


def sharded_rank(rank: int, size: int, port: int, transport: str, results, shape=None,
                 cells=("17a", "17b", "17c")) -> None:
    """One rank of phase 17, 18 or 19 (a spawned process): ``cells`` in
    order over a mesh of ``size`` ranks of ``shape`` (P, R) (default (size,
    1)), or a fleet mesh of (Bm, P, R), joined by ``transport``; in phases
    18 and 19, then each kernel of the path == its plain version on this
    rank's block."""
    import traceback

    import torch.distributed as dist

    from ringpop_tpu_torch.parallel import multihost
    from ringpop_tpu_torch.parallel.mesh import make_fleet_mesh, make_mesh

    cell_fns = {"17a": sharded_100k, "17b": sharded_headline, "17c": sharded_delta, "18a": sharded_100k,
                "18b": chaos_twins, "18c": churn_telemetry, "18d": headline_and_delta, "19a": fleet_twin_cell,
                "19b_p1": fleet_scale_cell,
                "19b_p2": lambda mesh: fleet_scale_cell(mesh, fleet_ckpt_path(), FSCALE_SAVE_AT),
                "19c": lambda mesh: fleet_restore_cell(mesh, fleet_ckpt_path())}
    try:
        dev = torch.device(f"cuda:{rank % torch.cuda.device_count()}")
        torch.cuda.set_device(dev)
        multihost.init_distributed(f"127.0.0.1:{port}", size, rank, transport=transport)
        if shape is not None and len(shape) == 3:
            mesh = make_fleet_mesh(shape=shape, transport=transport, device=dev)
        else:
            mesh = make_mesh(shape=shape, transport=transport, device=dev)
        out = {"rank": rank, "device": str(dev), "coords": mesh.coords}
        for cell in cells:
            out[cell] = cell_fns[cell](mesh)
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - the parent reports it and fails
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(size: int, transport: str, shape=None, cells=("17a", "17b", "17c"), what: str = "phase17"
                ) -> list[dict]:
    """Start ``size`` rank processes (``sharded_rank``), wait for every
    result (or the deadline), and stop every process; returns the ranks'
    records."""
    import queue
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=sharded_rank, args=(r, size, port, transport, results, shape, cells))
             for r in range(size)]
    for proc in procs:
        proc.start()
    got, failed = {}, []
    deadline = time.perf_counter() + SHARD_DEADLINE_S
    try:
        while len(got) + len(failed) < size:
            rank, ok, out = results.get(timeout=max(1.0, deadline - time.perf_counter()))
            (got.__setitem__(rank, out) if ok else failed.append((rank, out)))
    except queue.Empty:
        failed.append((-1, f"the ranks missed the {SHARD_DEADLINE_S} s deadline"))
    finally:
        for proc in procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join()
    for rank, tb in failed:
        log(f"{what}: rank {rank} failed:\n{tb}")
    check(not failed, f"{what}: every rank of {size} finished")
    return [got[r] for r in range(size)]


def sharded_references(dev: torch.device) -> dict:
    """The unsharded runs on this card that phases 17 and 18 hold their
    sharded cells to (not counted): sharded100k's 6 ticks and detect path
    (leaf digests, CUDA-event ms), the headline's ``run_until_detected``
    and the delta's ``run_until_converged`` (ms a tick)."""
    params, victims, faults = sh100k_config(dev)
    lifecycle._run_block(params, lifecycle.init_state(params, seed=SH100K_SEED, device=dev), faults, 1)  # warm-up
    state = lifecycle.init_state(params, seed=SH100K_SEED, device=dev)
    state, a_ms = event_timed(lambda: lifecycle._run_block(params, state, faults, SH100K_TICKS))
    ref_a = {"tick_ms": a_ms / SH100K_TICKS,
             "digests": leaf_digests(lifecycle.state_to_numpy(state), lifecycle.LifecycleState._fields)}
    (state, blocks, done), ad_ms = event_timed(lambda: lifecycle._run_until_detected_device(
        params, lifecycle.init_state(params, seed=SH100K_SEED, device=dev), faults,
        torch.as_tensor(victims, device=dev), min_status=FAULTY, block_ticks=SH100K_BLOCK_TICKS,
        max_blocks=SH100K_MAX_BLOCKS))
    ref_a["detect"] = {"blocks": blocks, "done": bool(done), "ms": ad_ms,
                       "digests": leaf_digests(lifecycle.state_to_numpy(state), lifecycle.LifecycleState._fields)}
    hv, hfaults = headline_faults(dev, LIFE_N)
    sim = lifecycle.LifecycleSim(n=LIFE_N, k=LIFE_K, seed=LIFE_SEED, rng="counter", device=dev)
    (bticks, _), b_ms = event_timed(lambda: sim.run_until_detected(hv, hfaults, max_ticks=LIFE_MAX_TICKS,
                                                            check_every=LIFE_CHECK_EVERY, blocks_per_dispatch=8))
    ref_b = {"tick_ms": b_ms / bticks, "detect_ms": b_ms}
    dparams = delta.DeltaParams(n=DELTA_N, k=DELTA_K, exchange="shift", rng="counter")
    (_, cticks, _), c_ms = event_timed(lambda: delta.run_until_converged(
        dparams, delta.init_state(dparams, seed=DELTA_SEED, device=dev), max_ticks=DELTA_MAX_TICKS,
        check_every=DELTA_CHECK_EVERY))
    ref_c = {"tick_ms": c_ms / cticks, "ms": c_ms}
    del state, sim
    torch.cuda.empty_cache()
    return {"a": ref_a, "b": ref_b, "c": ref_c}


def run_sharded(dev: torch.device, card: str, refs: dict) -> dict:
    """Phase 17: the three cells over SHARD_RANKS node ranks, each held to
    the unsharded references (``sharded_references``) and the JAX pins."""
    from ringpop_tpu_torch.parallel import multihost

    count = torch.cuda.device_count()
    transport = multihost.default_transport(SHARD_RANKS)
    log(f"phase17: {SHARD_RANKS} node ranks over {transport} ({count} card(s) visible: "
        f"{'one card a rank' if transport == 'nccl' else 'every leg staged through host memory'}); {card}")
    ref_a, ref_b, ref_c = refs["a"], refs["b"], refs["c"]
    t0 = time.perf_counter()
    ranks = spawn_ranks(SHARD_RANKS, transport)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    # 17a: sharded100k, every gathered leaf == the unsharded run on this card
    a = r0["17a"]
    check(a["digests"] == ref_a["digests"], "17a: every leaf after 6 sharded ticks == the unsharded run's")
    check((a["detect"]["blocks"], a["detect"]["done"]) == (ref_a["detect"]["blocks"], ref_a["detect"]["done"]),
          f"17a: detect blocks and verdict == unsharded ({a['detect']['blocks']}, {a['detect']['done']})")
    check(a["detect"]["digests"] == ref_a["detect"]["digests"], "17a: every leaf after the detect path == unsharded")
    # 17b: the headline's pins
    b = r0["17b"]
    check(b["twin_digests"] == PIN_LIFE_TWIN, f"17b: tick-{LIFE_TWIN_TICKS} digests == PIN_LIFE_TWIN")
    check(all(r["17b"]["l1_block"]["detect_equal"] and r["17b"]["l1_block"]["checksum_equal"] for r in ranks),
          "17b: L1 on every rank's block == its plain version (both modes)")
    check(b["detected"] and b["detect_ticks"] == PIN_LIFE_DETECT_TICKS,
          f"17b: detected in {b['detect_ticks']} ticks (pin {PIN_LIFE_DETECT_TICKS})")
    check(b["converged"] and b["converge_ticks"] == PIN_LIFE_CONVERGE_TICKS,
          f"17b: converged {b['converge_ticks']} ticks later (pin {PIN_LIFE_CONVERGE_TICKS})")
    check(b["digests"] == PIN_LIFE, "17b: every final leaf digest == PIN_LIFE")
    check(b["views_sum"] == PIN_LIFE_VIEWS_SUM and b["views_sha"] == PIN_LIFE_VIEWS_SHA,
          f"17b: view checksums sum {b['views_sum']} and sha == PIN_LIFE_VIEWS_*")
    check(all(r["17b"]["digest"] == b["whole_digest"] for r in ranks),
          f"17b: the partial-sum digest on every rank == tree_digest of the gathered state ({b['whole_digest']})")
    # 17c: delta 1M x 128
    c = r0["17c"]
    check(c["converged"] and c["ticks"] == PIN_SHIFT_TICKS,
          f"17c: converged in {c['ticks']} ticks (pin {PIN_SHIFT_TICKS})")
    check(c["digests"] == PIN_SHIFT and c["fraction"] == 1.0, "17c: final leaf digests == PIN_SHIFT, fraction 1.0")
    for cell in ("17a", "17b", "17c"):
        per_rank = [r[cell]["launches"] for r in ranks]
        check(all(x["row_reduce"] > 0 for x in per_rank), f"{cell}: S1 launched on every rank: {per_rank}")
    check(all(r["17b"]["launches"]["slot_walk"] > 0 and r["17b"]["launches"]["first_live_learner"] > 0
              and r["17b"]["launches"]["state_digest"] > 0 for r in ranks),
          "17b: L1, L2 and D1 launched on every rank")
    check(all(r["17c"]["launches"]["popcount_rows"] > 0 for r in ranks), "17c: S2 launched on every rank")
    refs = {"17a": ref_a, "17b": ref_b, "17c": ref_c}
    cells = {}
    for cell in ("17a", "17b", "17c"):
        rec = r0[cell]
        cells[cell] = {"sharded_ms_per_tick": [r[cell]["tick_ms"] for r in ranks],
                       "unsharded_ms_per_tick": refs[cell]["tick_ms"], "exchange_rank0": rec["exchange"],
                       "launches_per_rank": [r[cell]["launches"] for r in ranks]}
        ex = rec["exchange"]
        log(f"phase{cell}: ms/tick sharded {[round(x, 3) for x in cells[cell]['sharded_ms_per_tick']]} (ranks) vs "
            f"unsharded {refs[cell]['tick_ms']:.3f}; sends a leg {ex['sends_per_leg']} over {ex['legs']} legs; "
            f"per tick {ex['sends_per_tick']:.1f} sends, {ex['bytes_per_tick'] / 1e6:.3f} MB sent "
            f"({ex['send_bytes_per_tick'] / 1e6:.3f} MB legs + {ex['collective_bytes_per_tick'] / 1e6:.3f} MB "
            f"collectives, {ex['collectives_per_tick']:.1f} a tick), {ex['staged_bytes_per_tick'] / 1e6:.3f} MB "
            f"staged; launches by rank {cells[cell]['launches_per_rank']}; {card}")
    log(f"phase17: sharded100k == unsharded (detect {a['detect']['blocks']} blocks), headline == PIN_LIFE* "
        f"({b['detect_ticks']} + {b['converge_ticks']} ticks), delta == PIN_SHIFT ({c['ticks']} ticks) over "
        f"{SHARD_RANKS} ranks; L1 on blocks == plain {[r['17b']['l1_block'] for r in ranks]}; ranks' wall "
        f"{wall:.1f} s")
    return {"sharded": {"ranks": SHARD_RANKS, "transport": transport, "device_count": count, "card": card,
                        "cells": cells, "ranks_wall_s": wall,
                        "l1_block": [r["17b"]["l1_block"] for r in ranks]}}


# -- phase 18: the rumor axis ---------------------------------------------------

# churn100k's tick whose state the kernels are held to their plain versions
# on, rank by rank: two crash waves in (ticks 8 and 16), their suspicions in flight
CHURN_CHECK_TICK = 24
# the kernels a rumor-sharded tick, its queries and its telemetry run, by
# their wrappers' launch-count names
RUMOR_KERNELS = {**SHARD_KERNELS, "accumulate": "telemetry_accumulate", "f32_sums": "telemetry_f32_sums"}
# which of them each cell's main path must launch on every rank
RUMOR_CELL_KERNELS = {"18a": ("row_reduce", "first_live_learner"),
                      "18b": ("row_reduce", "first_live_learner", "state_digest"),
                      "18c": ("row_reduce", "first_live_learner", "state_digest", "accumulate", "f32_sums"),
                      "18d_headline": ("row_reduce", "slot_walk", "first_live_learner", "state_digest"),
                      "18d_delta": ("row_reduce", "popcount_rows")}


def rumor_launches() -> dict[str, int]:
    """Every launch count phase 18 reads (``shard_launches`` and P1, R1)."""
    return {**shard_launches(), "accumulate": telemetry_kernel.launches["accumulate"],
            "f32_sums": telemetry_kernel.launches["f32_sums"]}


def lead_rank(mesh) -> bool:
    return mesh.coords == {"node": 0, "rumor": 0}


def twin_params() -> lifecycle.LifecycleParams:
    return lifecycle.LifecycleParams(n=TWIN_N, k=TWIN_K, suspect_ticks=TWIN_SUSPECT_TICKS, rng="counter")


def twin_plan(name: str, builder: str, dev):
    build = topology.topo_scenario_plan if builder == "topo" else chaos.scenario_plan
    return build(name, TWIN_N, seed=TWIN_SEED, horizon=TWIN_HORIZON, device=dev)


def chaos_twins(mesh) -> dict:
    """18b on this rank: simbench's chaos twin, each plan's TWIN_TICKS ticks
    over the mesh and its digest combined from the ranks (the main path:
    counts 0 before the four plans, read after), then the leaves
    gathered."""
    from ringpop_tpu_torch.parallel import partition
    from ringpop_tpu_torch.parallel.mesh import with_exchange_mesh

    params = with_exchange_mesh(twin_params(), mesh)
    plans = {name: twin_plan(name, builder, mesh.device) for name, builder in TWIN_PLANS}
    states, ms, digests = {}, 0.0, {}
    shard_reset()
    shard_stats_reset(mesh)
    for name, plan in plans.items():
        states[name], t = event_timed(lambda: lifecycle._run_block(
            params, lifecycle.init_state(params, seed=TWIN_SEED), plan, TWIN_TICKS))
        ms += t
    exchange = exchange_record(mesh, TWIN_TICKS * len(plans))
    for name, state in states.items():
        digests[name] = int(telemetry.tree_digest(state, mesh))
    launches = rumor_launches()
    out = {"tick_ms": ms / (TWIN_TICKS * len(plans)), "launches": launches, "exchange": exchange, "plans": {}}
    for name, state in states.items():
        leaves = partition.host_gather(state, mesh)
        out["plans"][name] = {"digest": digests[name],
                              "digests": gathered_digests(leaves, lifecycle) if lead_rank(mesh) else None}
    return out


def churn_telemetry(mesh) -> dict:
    """18c on this rank: churn100k with telemetry on over the mesh
    (``tel_chaos_run``, rank (0, 0) writing the journal: the main path,
    counts 0 before it, read after), then every kernel of the slice held to
    its plain version on this rank's block of the same run's state at
    CHURN_CHECK_TICK (``block_kernel_checks``)."""
    from ringpop_tpu_torch.parallel.mesh import with_exchange_mesh

    plan = chaos.scenario_plan("churn", TEL_CHURN_N, seed=TEL_SEED, horizon=TEL_HORIZON, device=mesh.device)
    journal, path = None, OUT_DIR / "phase18_churn100k.jsonl"
    if lead_rank(mesh):
        OUT_DIR.mkdir(exist_ok=True)
        journal = telemetry.TelemetryJournal(str(path))
        journal.header("lifecycle", "churn100k", {"n": TEL_CHURN_N, "k": TEL_CHURN_K, "seed": TEL_SEED,
                                                   "mesh": list(mesh.shape.values())})
    shard_reset()
    shard_stats_reset(mesh)
    (res, sim), ms = event_timed(lambda: tel_chaos_run(mesh.device, plan, TEL_CHURN_N, TEL_CHURN_K, "churn100k",
                                                       journal=journal, mesh=mesh))
    launches = rumor_launches()
    exchange = exchange_record(mesh, TEL_HORIZON)
    out = {"tick_ms": ms / TEL_HORIZON, "launches": launches, "exchange": exchange, "records": res["records"],
           "score": res["score"]}
    if journal is not None:
        journal.close()
        out["journal"] = telemetry.read_journal(str(path))
    # the kernels on a block with slots in flight: the first two crash waves' suspicions at tick CHURN_CHECK_TICK
    params = with_exchange_mesh(lifecycle.LifecycleParams(n=TEL_CHURN_N, k=TEL_CHURN_K, suspect_ticks=TEL_SUSPECT_TICKS,
                                                          rng="counter"), mesh)
    mid = lifecycle._run_block(params, lifecycle.init_state(params, seed=TEL_SEED), plan, CHURN_CHECK_TICK)
    out["block_kernels"] = block_kernel_checks(mesh, mid, plan)
    return out


def block_kernel_checks(mesh, state, plan, n: int = TEL_CHURN_N, k: int = TEL_CHURN_K, cell: str = "18c") -> dict:
    """S1, S2, L1, L2, P1, D1 and R1 == their plain versions on this rank's
    block of ``state`` (18c: churn100k's at CHURN_CHECK_TICK, slots in
    flight; 19a: a replica of the fleet twin's; these launches are made
    after the cell's counts were read), ``mesh`` the (P, R) mesh the state
    is sharded over: S1 OR and
    AND over the live rows
    and S2 on the word block [rows, W/R], L1 both modes on the rank's rows
    with every word, L2 on the word block (every slot wanted), P1 on legs
    of the block's shapes (its planes, random masks), D1 on every leaf of
    the block at its global flat offset, R1 bit for bit on a record's
    inputs gathered whole (a uint32 plane, an int32 and a bool vector)."""
    from ringpop_tpu_torch.parallel import partition

    lo, hi = mesh.block(n)
    slots, words = delta.rumor_block(mesh, k)
    kl = slots.stop - slots.start
    faults = delta.resolve_faults(plan, state.tick)
    up = faults.up[lo:hi]
    plane = state.learned
    where = f"rank {mesh.coords} block [{hi - lo}, {plane.shape[1]}]"
    check(torch.equal(packbits_kernel.reduce_rows_cuda(plane, "or", up), packbits.or_reduce_rows_plain(plane, up))
          and torch.equal(packbits_kernel.reduce_rows_cuda(plane, "and", up), packbits.and_reduce_rows_plain(plane, up)),
          f"{cell}: S1 (OR, AND over the live rows) == plain on {where}")
    check(torch.equal(packbits_kernel.popcount_rows_cuda(plane), packbits.popcount_rows_plain(plane)),
          f"{cell}: S2 == plain on {where}")
    victims = np.flatnonzero(~faults.up.cpu().numpy())
    l1 = l1_block_check(state, mesh, victims, faults)
    check(l1["slots"] > 0 and l1["detect_equal"] and l1["checksum_equal"],
          f"{cell}: L1 (both modes) == plain on {where} with slots in flight: {l1}")
    check(torch.equal(lifecycle_kernel.first_live_learner_cuda(plane, up, kl),
                      lifecycle_kernel.first_live_learner_plain(plane, up, kl)), f"{cell}: L2 == plain on {where}")
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(SEED + 18 + mesh.rank)
    inp = random_accumulate_inputs(gen, hi - lo, plane.shape[1], mesh.device, "random")
    inp["legs"].update(sent_w=plane, resp_w=state.ride_ok, ride_ok=state.ride_ok, mid_ride_w=plane & state.ride_ok)
    got = {name: x.clone() for name, x in inp["acc"].items()}
    want = {name: x.clone() for name, x in inp["acc"].items()}
    telemetry_kernel.accumulate_cuda(got, **inp["legs"])
    telemetry.accumulate_plain(want, **inp["legs"])
    check(all(torch.equal(got[name], want[name]) for name in got), f"{cell}: P1 == plain on {where}")
    d1 = 0
    for name, leaf in partition.named_leaves(state):
        if partition._plane_rumor_axis(partition.spec_for(name)) is not None:
            leaf = mesh.gather_cols(leaf)
        node_sharded = partition.spec_for(name)[:1] == ("node",)
        offset = (lo * (leaf.numel() // leaf.shape[0])) & 0xFFFF_FFFF if node_sharded else 0
        got_d = telemetry_kernel.state_digest_cuda([leaf.contiguous()], offset=offset, final=False)
        check(torch.equal(got_d, telemetry.leaf_digest_sum_plain(leaf, offset)),
              f"{cell}: D1 == plain on {where}, leaf {name} at offset {offset}")
        d1 += 1
    whole = partition.host_gather({"learned": state.learned, "base_inc": state.base_inc,
                                   "base_present": state.base_present}, mesh)
    inputs = [(torch.from_numpy(whole["learned"]).to(mesh.device), True, False),
              (torch.from_numpy(whole["base_inc"]).to(mesh.device), False, False),
              (torch.from_numpy(whole["base_present"]).to(mesh.device), False, False)]
    check_r1(inputs, f"{cell}: on the gathered [{n}, {whole['learned'].shape[1]}] and [{n}] inputs")
    return {"rows": hi - lo, "words": plane.shape[1], "l1": l1, "d1_leaves": d1, "max_abs_err": 0}


def headline_and_delta(mesh) -> dict:
    """18d on this rank: the headline (17b's cell) and the delta (17c's)
    on a rumor-sharded mesh."""
    return {"headline": sharded_headline(mesh), "delta": sharded_delta(mesh)}


def rank_line(cell: str, r: dict, rec: dict, unsharded_ms: float, card: str) -> str:
    """One rank's line: ms a tick sharded and unsharded, per axis the
    collectives, bytes sent and bytes staged a tick, and the launches."""
    axes = "; ".join(
        f"{axis}: {ex['collectives_per_tick']:.1f} collectives {ex['collective_bytes_per_tick'] / 1e6:.3f} MB, "
        f"{ex['sends_per_tick']:.1f} sends {ex['send_bytes_per_tick'] / 1e6:.3f} MB, "
        f"{ex['staged_bytes_per_tick'] / 1e6:.3f} MB staged" for axis, ex in rec["exchange"]["by_axis"].items())
    return (f"phase{cell}: rank {r['rank']} {r['coords']}: ms/tick sharded {rec['tick_ms']:.3f} vs unsharded "
            f"{unsharded_ms:.3f}; a tick {axes}; launches {rec['launches']}; {card}")


def run_rumor_axis(dev: torch.device, card: str, refs: dict) -> dict:
    """Phase 18: the rumor axis.  The unsharded chaos twins and churn100k on
    this card (the twins == PIN_CHAOS_TWIN), then RUMOR_SHAPE's ranks run
    18a (sharded100k == the unsharded run), 18b (the four twins == the
    unsharded runs and the pins) and 18c (churn100k's journal == PIN_TEL_CHURN),
    and RUMOR_HEADLINE_SHAPE's ranks 18d (the headline == PIN_LIFE*, the
    delta == PIN_SHIFT)."""
    from ringpop_tpu_torch.parallel import multihost

    fields = lifecycle.LifecycleState._fields
    params = twin_params()
    twin_ref = {}
    for name, builder in TWIN_PLANS:
        plan = twin_plan(name, builder, dev)
        state, ms = event_timed(lambda: lifecycle._run_block(
            params, lifecycle.init_state(params, seed=TWIN_SEED, device=dev), plan, TWIN_TICKS))
        twin_ref[name] = {"tick_ms": ms / TWIN_TICKS, "digest": int(telemetry.tree_digest(state)),
                          "digests": leaf_digests(lifecycle.state_to_numpy(state), fields)}
        check(twin_ref[name]["digests"] == PIN_CHAOS_TWIN[name]["leaves"]
              and twin_ref[name]["digest"] == PIN_CHAOS_TWIN[name]["digest"],
              f"18b: the unsharded {name} twin on this card == PIN_CHAOS_TWIN")
    plan = chaos.scenario_plan("churn", TEL_CHURN_N, seed=TEL_SEED, horizon=TEL_HORIZON, device=dev)
    (res, sim), churn_ms = event_timed(lambda: tel_chaos_run(dev, plan, TEL_CHURN_N, TEL_CHURN_K, "churn100k"))
    check(records_match(res["records"], PIN_TEL_CHURN["records"]), "18c: the unsharded churn100k == PIN_TEL_CHURN")
    del sim, state
    torch.cuda.empty_cache()
    unsharded = {"18a": refs["a"]["tick_ms"], "18b": statistics.fmean(r["tick_ms"] for r in twin_ref.values()),
                 "18c": churn_ms / TEL_HORIZON, "18d_headline": refs["b"]["tick_ms"], "18d_delta": refs["c"]["tick_ms"]}

    size, size_d = RUMOR_SHAPE[0] * RUMOR_SHAPE[1], RUMOR_HEADLINE_SHAPE[0] * RUMOR_HEADLINE_SHAPE[1]
    transport, transport_d = multihost.default_transport(size), multihost.default_transport(size_d)
    log(f"phase18: {RUMOR_SHAPE} ranks over {transport} for 18a-c, {RUMOR_HEADLINE_SHAPE} over {transport_d} for "
        f"18d ({torch.cuda.device_count()} card(s) visible); {card}")
    t0 = time.perf_counter()
    ranks = spawn_ranks(size, transport, RUMOR_SHAPE, ("18a", "18b", "18c"), "phase18")
    wall_abc = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks_d = spawn_ranks(size_d, transport_d, RUMOR_HEADLINE_SHAPE, ("18d",), "phase18d")
    wall_d = time.perf_counter() - t0
    r0, d0 = ranks[0], ranks_d[0]
    # 18a: sharded100k at its own 4 x 2 == the unsharded run on this card
    a, ref_a = r0["18a"], refs["a"]
    check(a["digests"] == ref_a["digests"], "18a: every leaf after 6 ticks on 4 x 2 == the unsharded run's")
    check((a["detect"]["blocks"], a["detect"]["done"]) == (ref_a["detect"]["blocks"], ref_a["detect"]["done"]),
          f"18a: detect blocks and verdict == unsharded ({a['detect']['blocks']}, {a['detect']['done']})")
    check(a["detect"]["digests"] == ref_a["detect"]["digests"], "18a: every leaf after the detect path == unsharded")
    # 18b: the chaos twins
    for name, _ in TWIN_PLANS:
        got = r0["18b"]["plans"][name]
        check(got["digests"] == twin_ref[name]["digests"], f"18b: {name}: every leaf on 4 x 2 == the unsharded run's")
        check(all(r["18b"]["plans"][name]["digest"] == PIN_CHAOS_TWIN[name]["digest"] for r in ranks),
              f"18b: {name}: the digest combined on every rank == PIN_CHAOS_TWIN ({got['digest']})")
    # 18c: churn100k's journal over the mesh
    c = r0["18c"]
    check(records_match(c["records"], PIN_TEL_CHURN["records"]),
          f"18c: block records on 4 x 2 == the JAX pins: {record_diff(c['records'], PIN_TEL_CHURN['records'])}")
    check(c["score"] == PIN_TEL_CHURN["score"], f"18c: the verdict == the JAX pin: {c['score']}")
    check(all(r["18c"]["records"] == c["records"] for r in ranks), "18c: every rank's records are the same")
    check(c["journal"][-1] == json.loads(json.dumps(c["score"])) and len(c["journal"]) == 2 + len(c["records"]),
          "18c: the scored journal round-trips")
    check(all(r["18c"]["launches"]["accumulate"] == TEL_HORIZON
              and r["18c"]["launches"]["f32_sums"] == 2 * TEL_HORIZON // TEL_BLOCK for r in ranks),
          "18c: P1 once a tick and R1 twice a block on every rank")
    # 18d: the headline and the delta at full width on 2 x 2
    b = d0["18d"]["headline"]
    check(b["twin_digests"] == PIN_LIFE_TWIN, f"18d: tick-{LIFE_TWIN_TICKS} digests == PIN_LIFE_TWIN")
    check(all(r["18d"]["headline"]["l1_block"]["detect_equal"] and r["18d"]["headline"]["l1_block"]["checksum_equal"]
              for r in ranks_d), "18d: L1 on every rank's rows (every word) == its plain version (both modes)")
    check(b["detected"] and b["detect_ticks"] == PIN_LIFE_DETECT_TICKS,
          f"18d: detected in {b['detect_ticks']} ticks (pin {PIN_LIFE_DETECT_TICKS})")
    check(b["converged"] and b["converge_ticks"] == PIN_LIFE_CONVERGE_TICKS,
          f"18d: converged {b['converge_ticks']} ticks later (pin {PIN_LIFE_CONVERGE_TICKS})")
    check(b["digests"] == PIN_LIFE, "18d: every final leaf digest == PIN_LIFE")
    check(b["views_sum"] == PIN_LIFE_VIEWS_SUM and b["views_sha"] == PIN_LIFE_VIEWS_SHA,
          f"18d: view checksums sum {b['views_sum']} and sha == PIN_LIFE_VIEWS_*")
    check(all(r["18d"]["headline"]["digest"] == b["whole_digest"] for r in ranks_d),
          f"18d: the combined digest on every rank == tree_digest of the gathered state ({b['whole_digest']})")
    dd = d0["18d"]["delta"]
    check(dd["converged"] and dd["ticks"] == PIN_SHIFT_TICKS,
          f"18d: the delta converged in {dd['ticks']} ticks (pin {PIN_SHIFT_TICKS})")
    check(dd["digests"] == PIN_SHIFT and dd["fraction"] == 1.0, "18d: the delta's leaf digests == PIN_SHIFT")
    # every cell's kernels launched on every rank of its main path
    per_cell = {"18a": [r["18a"] for r in ranks], "18b": [r["18b"] for r in ranks], "18c": [r["18c"] for r in ranks],
                "18d_headline": [r["18d"]["headline"] for r in ranks_d], "18d_delta": [r["18d"]["delta"] for r in ranks_d]}
    cells = {}
    for cell, recs in per_cell.items():
        launches = [{name: rec["launches"].get(name, 0) for name in RUMOR_KERNELS} for rec in recs]
        for name in RUMOR_CELL_KERNELS[cell]:
            check(all(x[name] > 0 for x in launches), f"{cell}: {RUMOR_KERNELS[name]} launched on every rank: {launches}")
        group_ranks = ranks if cell[:3] != "18d" else ranks_d
        for r, rec in zip(group_ranks, recs):
            log(rank_line(cell, r, rec, unsharded[cell], card))
        cells[cell] = {"sharded_ms_per_tick": [rec["tick_ms"] for rec in recs], "unsharded_ms_per_tick": unsharded[cell],
                       "exchange_per_rank": [rec["exchange"] for rec in recs], "launches_per_rank": launches}
    blocks = [r["18c"]["block_kernels"] for r in ranks]
    log(f"phase18: sharded100k == unsharded on {RUMOR_SHAPE} (detect {a['detect']['blocks']} blocks), the four chaos "
        f"twins == PIN_CHAOS_TWIN, churn100k's {len(c['records'])} records and verdict == PIN_TEL_CHURN; headline == "
        f"PIN_LIFE* ({b['detect_ticks']} + {b['converge_ticks']} ticks) and delta == PIN_SHIFT on "
        f"{RUMOR_HEADLINE_SHAPE}; S1, S2, L1, L2, P1, D1, R1 == plain on every rank's block {blocks}; ranks' wall "
        f"{wall_abc:.1f} + {wall_d:.1f} s; {card}")
    return {"rumor_axis": {"shape": list(RUMOR_SHAPE), "headline_shape": list(RUMOR_HEADLINE_SHAPE),
                           "transport": transport, "card": card, "cells": cells,
                           "ranks_wall_s": [wall_abc, wall_d], "block_kernels": blocks}}


# -- phase 19: the fleet's meshes, the process-sliced sweep and its checkpoints --

# simbench's fleet twin (_fleet_sharded_twin, ringpop_tpu/cli/simbench.py:1319-1370, as
# bench_fleet_scale calls it with full=True): n 4096 x k 64, suspect_ticks 10, counter, 4 victims
# from default_rng(seed), doses [0, n // 64, n // 32] x losses (0, 0.05) (B = 6), churn_seed seed +
# 777, grid_seeds, 24 ticks with telemetry, seed 0; unsharded and over a (2, 2, 2) fleet mesh
FTWIN_N, FTWIN_K, FTWIN_TICKS, FTWIN_SEED, FTWIN_SUSPECT_TICKS, FTWIN_SHAPE = 4096, 64, 24, 0, 10, (2, 2, 2)
# then both fleets run run_until_detected for this long, checked every 8 ticks: L1 and the batch
# axis' detection flags on the main path
FTWIN_DETECT_TICKS, FTWIN_CHECK_EVERY = 16, 8
# simbench's fleet_scale legs 1-2 (cli/simbench.py:1424-1462, the worker cli/fleet_bench.py:63-200)
# at full width: 4096 x 64, losses 0 / 0.05 / 0.1 / 0.15, suspect_ticks 10, counter, horizon 32 in
# 16-tick blocks, saved at 16, seed 0; b_doses cut from simbench's 512 to 16 (B 2048 -> 64)
FSCALE_N, FSCALE_K, FSCALE_B_DOSES, FSCALE_LOSSES = 4096, 64, 16, (0.0, 0.05, 0.1, 0.15)
FSCALE_HORIZON, FSCALE_BLOCK, FSCALE_SAVE_AT, FSCALE_SEED, FSCALE_SUSPECT_TICKS = 32, 16, 16, 0, 10
FSCALE_P, FSCALE_MESH = 2, (2, 2, 1)  # 19b's sliced run; 19c's fleet mesh
FSCALE_MEM_FRAC = 0.75  # simbench.py:1505: the P = 2 ranks' peak under this share of the P = 1 run's
# the kernels of phase 19's path and, by cell, the ones every rank must launch
FLEET_MESH_KERNELS = {"19a": ("row_reduce", "slot_walk", "first_live_learner", "accumulate", "state_digest",
                              "f32_sums"),
                      "19b": ("row_reduce", "first_live_learner", "accumulate", "state_digest", "f32_sums"),
                      "19c": ("row_reduce", "first_live_learner", "accumulate", "state_digest", "f32_sums")}
# pinned from the JAX package (ringpop_tpu.sim.montecarlo, .scenarios) run unsharded on the CPU;
# tests/test_torch_chip_smoke_pins_fleet_mesh.py recomputes them
PIN_FLEET_TWIN = {  # the twin's digests after its 24 ticks; the detection leg's ticks, flags and digests after
    "digests": [3649510496, 3736333607, 1554371877, 282829271, 1430575962, 2101753252],
    "detect": [[0, 0, -1, 0, 16, -1], [True, True, False, True, True, False]],
    "detect_digests": [725736707, 3540596554, 530570103, 698668351, 2700286302, 994100329],
}
PIN_FLEET_SCALE = {  # every scenario's digest at the horizon, and the scores' scores_sha256
    "digests": {
        "0": 837275278, "1": 817098182, "2": 4234126247, "3": 3797387813, "4": 1167183807, "5": 2583633012,
        "6": 165917314, "7": 2775113829, "8": 1767017289, "9": 257369324, "10": 3002621251, "11": 3030655987,
        "12": 3390055662, "13": 1491874131, "14": 140828778, "15": 1916413176, "16": 1146317761, "17": 2058881738,
        "18": 1248703846, "19": 3042980656, "20": 1957500368, "21": 1823632675, "22": 178624856, "23": 392301968,
        "24": 3007312984, "25": 3391996479, "26": 2609635789, "27": 1214024432, "28": 4093240144, "29": 3434442224,
        "30": 1491705505, "31": 1967016262, "32": 127005454, "33": 487117158, "34": 3425295850, "35": 818982208,
        "36": 3073627106, "37": 4035139196, "38": 2909317966, "39": 2187767115, "40": 1361204472, "41": 2267755991,
        "42": 3421338124, "43": 3207271160, "44": 2757883856, "45": 91626334, "46": 1884888172, "47": 4016512750,
        "48": 669497924, "49": 1477411995, "50": 4049222655, "51": 2456291663, "52": 70408509, "53": 2682294011,
        "54": 3659872509, "55": 2542636109, "56": 2185733998, "57": 3798764584, "58": 3867492975, "59": 3365355896,
        "60": 2434099682, "61": 244232086, "62": 2147246612, "63": 746767259,
    },
    "scores_sha256": "0a44094d1ff89d7b4328410b5c7a113e1f3fc4363dd0acdd71bef82555ed7c8f",
}


def scores_sha256(scores: list) -> str:
    """sha256 of score records as JSON, keys sorted and every number a
    float, so that records Python holds equal (1 == 1.0 == True) hash
    alike."""
    def canon(x):
        if isinstance(x, dict):
            return {str(key): canon(v) for key, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [canon(v) for v in x]
        return float(x) if isinstance(x, (bool, int, float)) else x

    return hashlib.sha256(json.dumps(canon(scores), sort_keys=True).encode()).hexdigest()


def fleet_twin_grid(dev, n: int = FTWIN_N, k: int = FTWIN_K):
    """The fleet twin's configuration: (params, victims, plan, seeds)."""
    params = lifecycle.LifecycleParams(n=n, k=k, suspect_ticks=FTWIN_SUSPECT_TICKS, rng="counter")
    victims = sorted(np.random.default_rng(FTWIN_SEED).choice(n, size=4, replace=False).tolist())
    plan, meta = scenarios.scenario_grid(n, victims=victims, doses=[0, n // 64, n // 32], losses=(0.0, 0.05),
                                         churn_seed=FTWIN_SEED + 777, device=dev)
    return params, victims, plan, scenarios.grid_seeds(meta, FTWIN_SEED)


def fleet_twin_run(dev, n: int = FTWIN_N, k: int = FTWIN_K, mesh=None):
    """simbench's fleet twin on ``dev`` (on ``mesh``, a fleet mesh, when
    given): the grid's fleet with telemetry on, FTWIN_TICKS ticks and a
    fetch (the records; their digests in scenario order), then
    ``run_until_detected`` for FTWIN_DETECT_TICKS ticks (the ticks, the
    flags and every replica's digest).  Returns (that, the fleet)."""
    params, victims, plan, seeds = fleet_twin_grid(dev, n, k)
    mc = montecarlo.MonteCarlo(params, seeds, telemetry=True, mesh=mesh, device=dev)
    mc.advance(FTWIN_TICKS, plan)
    records = mc.fetch_telemetry(plan)
    ticks, detected = mc.run_until_detected(victims, plan, max_ticks=FTWIN_DETECT_TICKS, check_every=FTWIN_CHECK_EVERY)
    return {"records": records, "digests": [r["state_digest"] for r in records],
            "detect": [ticks.tolist(), detected.tolist()], "detect_digests": mc.digests()}, mc


def fleet_scale_grid(dev, n: int = FSCALE_N, k: int = FSCALE_K, b_doses: int = FSCALE_B_DOSES,
                     losses=FSCALE_LOSSES):
    """``fleet_bench.build_grid``'s grid: 4 victims from
    ``default_rng(seed)``, ``mc_churn_doses(b_doses, n // 32)`` x ``losses``,
    churn_seed seed + 777, ``grid_seeds``.  Returns (params, plan, meta,
    seeds)."""
    params = lifecycle.LifecycleParams(n=n, k=k, suspect_ticks=FSCALE_SUSPECT_TICKS, rng="counter")
    victims = sorted(np.random.default_rng(FSCALE_SEED).choice(n, size=4, replace=False).tolist())
    doses = scenarios.mc_churn_doses(b_doses, n // 32)
    plan, meta = scenarios.scenario_grid(n, victims=victims, doses=doses, losses=losses,
                                         churn_seed=FSCALE_SEED + 777, device=dev)
    return params, plan, meta, scenarios.grid_seeds(meta, FSCALE_SEED)


def fleet_scale_sweep(dev, path: str | None = None, save_at: int = 0, restore: bool = False, mesh=None,
                      horizon: int = FSCALE_HORIZON, **grid_kw) -> dict:
    """One process of ``fleet_bench``'s ``sweep`` / ``sweep-restore`` legs:
    this process's ``process_block`` slice of the grid (the whole grid on a
    fleet ``mesh``) as a scored ``FleetSweep``, saved at ``save_at`` into
    ``path`` and run on, or restored from ``path`` (at this process count
    or onto ``mesh``) and run on, to the horizon.  Returns its digests,
    scores, header, wall and save or restore seconds."""
    from ringpop_tpu_torch.parallel import multihost, partition

    params, plan, meta, seeds = fleet_scale_grid(dev, **grid_kw)
    b = len(meta)
    if mesh is None:
        lo, hi = partition.process_block(b, multihost.process_index(), multihost.process_count())
        plan, meta, seeds = chaos.slice_plan(plan, lo, hi), meta[lo:hi], seeds[lo:hi]
    kw = {"scenario": "fleet_scale", "device": dev, "mesh": mesh, "global_b": None if mesh is not None else b}
    out = {}
    t0 = time.perf_counter()
    if restore:
        sweep = scenarios.FleetSweep.restore(path, params, plan, meta, seeds, **kw)
        out["restore_s"] = time.perf_counter() - t0
    else:
        sweep = scenarios.FleetSweep(params, plan, meta, seeds, horizon=horizon, journal_every=FSCALE_BLOCK, **kw)
        if save_at:
            sweep.run(until_tick=save_at)
            t1 = time.perf_counter()
            sweep.save(path)
            out["save_s"] = time.perf_counter() - t1
    sweep.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out.update(wall_s=time.perf_counter() - t0, digests=sweep.digests(), scores=sweep.scores(),
               header=sweep.header_params())
    return out


def fleet_reset(mesh) -> None:
    """Every rank at this point, then the counts and the mesh's stats 0."""
    import torch.distributed as dist

    torch.cuda.synchronize()
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier(device_ids=[mesh.device.index] if mesh.transport == "nccl" else None)
    mesh.reset_stats()
    shard_reset()


def fleet_twin_cell(mesh) -> dict:
    """19a on this rank: the fleet twin over the fleet mesh (the main path,
    counts 0 before it, read after), then every kernel of the path held to
    its plain version on this rank's block of one of its replicas, the one
    with the most slots in flight."""
    fleet_reset(mesh)
    (out, mc), ms = event_timed(lambda: fleet_twin_run(mesh.device, mesh=mesh))
    ticks = int(mc._states[0].tick)
    out.update(tick_ms=ms / ticks, launches=rumor_launches(), exchange=exchange_record(mesh, ticks), block=mc.block,
               coords=mesh.coords)
    # the rank's replica with the most rumor slots in flight (the table is whole on every rank of its group)
    i = max(range(len(mc._states)), key=lambda j: (int((mc._states[j].r_subject >= 0).sum()), -j))
    _, _, plan, _ = fleet_twin_grid(mesh.device)
    out["block_kernels"] = block_kernel_checks(mesh.inner, mc._states[i], chaos.index_plan(plan, mc.block[0] + i),
                                               FTWIN_N, FTWIN_K, "19a")
    return out


def fleet_memory(out: dict) -> dict:
    """The process's device-memory peak since the last reset and its host
    peak RSS, in MB."""
    import resource

    out["peak_device_mb"] = torch.cuda.max_memory_allocated() / 2**20
    out["peak_rss_mb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    return out


def fleet_scale_cell(mesh, path: str | None = None, save_at: int = 0) -> dict:
    """19b on this rank: its slice of the scored sweep (saved at ``save_at``
    into ``path`` when given), the device peak reset just before."""
    fleet_reset(mesh)
    torch.cuda.reset_peak_memory_stats()
    out = fleet_scale_sweep(mesh.device, path, save_at)
    out["launches"] = rumor_launches()
    if path is not None:
        from ringpop_tpu_torch.parallel import multihost

        shard = Path(path) / f"shard-{multihost.process_index():05d}.npz"
        out["bytes_written"] = shard.stat().st_size if shard.exists() else 0
    return fleet_memory(out)


def fleet_restore_cell(mesh, path: str) -> dict:
    """19c on this rank: the P = 2 checkpoint restored onto the fleet mesh
    and run to the horizon."""
    fleet_reset(mesh)
    out = fleet_scale_sweep(mesh.device, path, restore=True, mesh=mesh)
    ticks = FSCALE_HORIZON - FSCALE_SAVE_AT
    out.update(launches=rumor_launches(), coords=mesh.coords, exchange=exchange_record(mesh, ticks),
               tick_ms=(out["wall_s"] - out["restore_s"]) * 1e3 / ticks)
    return out


def fleet_ckpt_path() -> str:
    return str((OUT_DIR / "phase19_fleet_ckpt").resolve())


def fleet_merged(ranks: list) -> dict:
    """The per-scenario digests and scores of a process-sliced run's ranks."""
    digests, scores = {}, []
    for r in ranks:
        digests.update(r["digests"])
        scores += r["scores"]
    return {"digests": digests, "scores": sorted(scores, key=lambda sc: sc["scenario_id"])}


def check_fleet_launches(cell: str, ranks: list) -> None:
    for name in FLEET_MESH_KERNELS[cell]:
        check(all(r["launches"][name] > 0 for r in ranks),
              f"{cell}: {RUMOR_KERNELS[name]} launched on every rank: {[r['launches'][name] for r in ranks]}")


def run_fleet_mesh(dev: torch.device, card: str) -> dict:
    """Phase 19: the fleet's meshes, the process-sliced sweep and its
    checkpoints.  19a simbench's fleet twin unsharded on this card (==
    PIN_FLEET_TWIN), then over a (2, 2, 2) fleet mesh of 8 ranks (every
    rank's records == the unsharded run's; the kernels == plain on every
    rank's block); 19b fleet_scale's scored sweep at P = 1, at P = 2 saved
    at tick 16, and restored here at P = 1 (digests and scores == each other
    and PIN_FLEET_SCALE; the P = 2 ranks' device peak under FSCALE_MEM_FRAC
    of the P = 1 run's); 19c the P = 2 checkpoint restored onto a (2, 2, 1)
    fleet mesh (== PIN_FLEET_SCALE)."""
    from ringpop_tpu_torch.parallel import multihost

    out = {"card": card}
    shard_reset()
    (ref, ref_mc), ref_ms = event_timed(lambda: fleet_twin_run(dev))
    ref_launches = rumor_launches()
    ref_ticks = int(ref_mc._states[0].tick)
    del ref_mc
    check(ref["digests"] == PIN_FLEET_TWIN["digests"], f"19a: the unsharded twin's 6 digests == PIN_FLEET_TWIN")
    check(ref["detect"] == PIN_FLEET_TWIN["detect"] and ref["detect_digests"] == PIN_FLEET_TWIN["detect_digests"],
          f"19a: the unsharded twin's detection leg {ref['detect']} == PIN_FLEET_TWIN")
    size = FTWIN_SHAPE[0] * FTWIN_SHAPE[1] * FTWIN_SHAPE[2]
    transport = multihost.default_transport(size)
    log(f"phase19: {FTWIN_SHAPE} (batch x node x rumor) ranks over {transport} for 19a; {card}")
    t0 = time.perf_counter()
    ranks = spawn_ranks(size, transport, FTWIN_SHAPE, ("19a",), "phase19a")
    wall_a = time.perf_counter() - t0
    twin = [r["19a"] for r in ranks]
    for r in twin:
        check(r["records"] == ref["records"], f"19a: rank {r['coords']}: every record over the mesh == unsharded")
        check(r["detect"] == ref["detect"] and r["detect_digests"] == ref["detect_digests"],
              f"19a: rank {r['coords']}: detection {r['detect']} and digests == unsharded")
    check_fleet_launches("19a", twin)
    for r in twin:
        log(f"phase19a: rank {r['coords']} replicas {r['block']}: ms a fleet tick {r['tick_ms']:.3f} over the mesh vs "
            f"{ref_ms / ref_ticks:.3f} unsharded; by axis a tick {json.dumps(r['exchange']['by_axis'])}; "
            f"launches {r['launches']}; {card}")
    out["19a"] = {"ranks_wall_s": wall_a, "unsharded_ms_per_tick": ref_ms / ref_ticks, "unsharded_launches": ref_launches,
                  "sharded_ms_per_tick": [r["tick_ms"] for r in twin], "exchange_per_rank": [r["exchange"] for r in twin],
                  "launches_per_rank": [r["launches"] for r in twin], "block_kernels": [r["block_kernels"] for r in twin]}

    # 19b: P = 1, P = 2 saved mid-sweep, P = 1 restored
    path = fleet_ckpt_path()
    OUT_DIR.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    p1 = spawn_ranks(1, multihost.default_transport(1), None, ("19b_p1",), "phase19b")[0]["19b_p1"]
    p1_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    p2 = [r["19b_p2"] for r in spawn_ranks(FSCALE_P, multihost.default_transport(FSCALE_P), None, ("19b_p2",),
                                          "phase19b")]
    p2_wall = time.perf_counter() - t0
    shard_reset()
    restored = fleet_scale_sweep(dev, path, restore=True)
    restored_launches = rumor_launches()
    want = {"digests": {int(k): v for k, v in PIN_FLEET_SCALE["digests"].items()}}
    check(p1["digests"] == want["digests"] and scores_sha256(p1["scores"]) == PIN_FLEET_SCALE["scores_sha256"],
          f"19b: P = 1: the {len(p1['digests'])} digests and scores == PIN_FLEET_SCALE")
    merged = fleet_merged(p2)
    check(merged["digests"] == p1["digests"] and merged["scores"] == p1["scores"],
          "19b: P = 2 (saved at tick 16): every digest and score == the P = 1 run's")
    check(restored["digests"] == p1["digests"] and restored["scores"] == p1["scores"]
          and restored["header"]["resumed"]["saved_process_count"] == FSCALE_P,
          f"19b: restored at P = 1 from the P = {FSCALE_P} checkpoint: every digest and score == the P = 1 run's")
    mem_frac = max(r["peak_device_mb"] for r in p2) / p1["peak_device_mb"]
    check(mem_frac < FSCALE_MEM_FRAC, f"19b: the P = 2 ranks' device peak is {mem_frac:.3f} of the P = 1 run's "
          f"(< {FSCALE_MEM_FRAC})")
    check_fleet_launches("19b", [p1, *p2, {"launches": restored_launches}])
    log(f"phase19b: fleet_scale {FSCALE_N} x {FSCALE_K}, B {len(p1['digests'])}, {FSCALE_HORIZON} ticks: P = 1 "
        f"{p1['wall_s']:.3f} s ({p1['wall_s'] * 1e3 / FSCALE_HORIZON:.3f} ms a fleet tick), P = 2 "
        f"{[round(r['wall_s'], 3) for r in p2]} s (save {[round(r['save_s'], 3) for r in p2]} s, "
        f"{[r['bytes_written'] for r in p2]} bytes a rank), restored at P = 1 {restored['wall_s']:.3f} s (restore "
        f"{restored['restore_s']:.3f} s); device peak P = 1 {p1['peak_device_mb']:.1f} MB, P = 2 "
        f"{[round(r['peak_device_mb'], 1) for r in p2]} MB (frac {mem_frac:.3f}); host peak RSS P = 1 "
        f"{p1['peak_rss_mb']:.1f} MB, P = 2 {[round(r['peak_rss_mb'], 1) for r in p2]} MB; launches P = 1 "
        f"{p1['launches']}, P = 2 {[r['launches'] for r in p2]}, restored {restored_launches}; processes' walls "
        f"{p1_wall:.1f} / {p2_wall:.1f} s; {card}")
    out["19b"] = {"b": len(p1["digests"]), "p1_wall_s": p1["wall_s"], "p2_wall_s": [r["wall_s"] for r in p2],
                  "save_s": [r["save_s"] for r in p2], "bytes_written": [r["bytes_written"] for r in p2],
                  "restore_s": restored["restore_s"], "restored_wall_s": restored["wall_s"],
                  "peak_device_mb": [p1["peak_device_mb"]] + [r["peak_device_mb"] for r in p2], "mem_frac": mem_frac,
                  "peak_rss_mb": [p1["peak_rss_mb"]] + [r["peak_rss_mb"] for r in p2],
                  "launches_per_rank": [p1["launches"]] + [r["launches"] for r in p2] + [restored_launches]}

    # 19c: the P = 2 checkpoint restored onto a (2, 2, 1) fleet mesh
    size = FSCALE_MESH[0] * FSCALE_MESH[1] * FSCALE_MESH[2]
    t0 = time.perf_counter()
    mesh_ranks = [r["19c"] for r in spawn_ranks(size, multihost.default_transport(size), FSCALE_MESH, ("19c",),
                                                "phase19c")]
    wall_c = time.perf_counter() - t0
    for r in mesh_ranks:
        check(r["digests"] == want["digests"] and scores_sha256(r["scores"]) == PIN_FLEET_SCALE["scores_sha256"],
              f"19c: rank {r['coords']}: restored onto {FSCALE_MESH}, every digest and score == PIN_FLEET_SCALE")
    check_fleet_launches("19c", mesh_ranks)
    for r in mesh_ranks:
        log(f"phase19c: rank {r['coords']}: restored onto {FSCALE_MESH} in {r['restore_s']:.3f} s, then ms a fleet "
            f"tick {r['tick_ms']:.3f} over the mesh vs {p1['wall_s'] * 1e3 / FSCALE_HORIZON:.3f} at P = 1; by axis a "
            f"tick {json.dumps(r['exchange']['by_axis'])}; launches {r['launches']}; {card}")
    out["19c"] = {"ranks_wall_s": wall_c, "restore_s": [r["restore_s"] for r in mesh_ranks],
                  "wall_s": [r["wall_s"] for r in mesh_ranks], "sharded_ms_per_tick": [r["tick_ms"] for r in mesh_ranks],
                  "exchange_per_rank": [r["exchange"] for r in mesh_ranks],
                  "launches_per_rank": [r["launches"] for r in mesh_ranks]}
    log(f"phase19: twin == PIN_FLEET_TWIN on {FTWIN_SHAPE} (ranks' wall {wall_a:.1f} s), fleet_scale at P = 1, "
        f"P = {FSCALE_P} and restored == PIN_FLEET_SCALE, device peak frac {mem_frac:.3f}, restored onto "
        f"{FSCALE_MESH} == PIN_FLEET_SCALE; {card}")
    return {"fleet_mesh": out}


def build_kernels() -> None:
    """Build every kernel source at once, one nvcc each."""
    t0 = time.perf_counter()
    modules = (hash_kernel, packbits_kernel, lifecycle_kernel, threefry_kernel, fullview_kernel, telemetry_kernel)
    with ThreadPoolExecutor(len(modules)) as ex:
        libs = list(ex.map(lambda m: m.build(), modules))
    log(f"build: {[lib.name for lib in libs]} in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"build: ptxas ({lib.stem.split('_')[0]}): {line.strip()}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, torch {torch.__version__}, cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    if sys.argv[1:] == ["--kernel-profile"]:
        log(json.dumps({"card": card, "profile": kernel_profile(torch.device("cuda"))}))
        return 0
    if sys.argv[1:] == ["--lifecycle-kernels"]:
        lifecycle_kernel.build()
        log(json.dumps({"card": card, "max_abs_err": phase8_lifecycle_kernels(torch.device("cuda"))}))
        return 0
    if sys.argv[1:] == ["--learner-planes"]:
        lifecycle_kernel.build()
        log(json.dumps({"card": card, "learner_planes": learner_planes(torch.device("cuda"))}))
        return 0
    if sys.argv[1:] == ["--threefry"]:
        build_kernels()
        kernels, timings = run_threefry(torch.device("cuda"))
        log(json.dumps({"card": card, "kernels": kernels, **timings}))
        return 0
    if sys.argv[1:] == ["--fullview"]:
        build_kernels()
        kernels, timings = run_fullview(torch.device("cuda"))
        log(json.dumps({"card": card, "kernels": kernels, **timings}))
        return 0
    if sys.argv[1:] == ["--telemetry"]:
        build_kernels()
        kernels, timings = run_telemetry(torch.device("cuda"))
        log(json.dumps({"card": card, "kernels": kernels, **timings}))
        return 0
    if sys.argv[1:] == ["--fleet"]:
        build_kernels()
        log(json.dumps({"card": card, **run_fleet(torch.device("cuda"))}))
        return 0
    if sys.argv[1:] == ["--serve"]:
        log(json.dumps({"card": card, **run_serve(torch.device("cuda"))}))
        return 0
    if sys.argv[1:] in (["--sharded"], ["--rumor-axis"]):
        build_kernels()
        refs = sharded_references(torch.device("cuda"))
        out = {} if sys.argv[1] == "--rumor-axis" else run_sharded(torch.device("cuda"), card, refs)
        out.update(run_rumor_axis(torch.device("cuda"), card, refs))
        log(json.dumps(out))
        return 0
    if sys.argv[1:] == ["--fleet-mesh"]:
        build_kernels()
        t0 = time.perf_counter()
        out = run_fleet_mesh(torch.device("cuda"), card)
        log(f"phase 19 wall {time.perf_counter() - t0:.1f} s; {card}")
        log(json.dumps(out))
        return 0
    if sys.argv[1:2] == ["--detect-wall"] and sys.argv[2:] in ([], ["counter"], ["threefry"]):
        rng = (sys.argv[2:] or ["counter"])[0]
        log(json.dumps({"card": card, "rng": rng, "detect_ms": detect_wall(torch.device("cuda"), rng)}))
        return 0
    walls = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(torch.device("cuda"), *args)
        walls[name] = time.perf_counter() - t0
        return out

    build_kernels()
    kernels, timings = phase("1-4", run, N_SERVERS, N_KEYS)
    delta_kernels, delta_timings = phase("5-7", run_delta)
    life_kernels, life_timings = phase("8-9", run_lifecycle)
    tf_kernels, tf_timings = phase("10-11", run_threefry)
    fv_kernels, fv_timings = phase("12-13", run_fullview)
    tel_kernels, tel_timings = phase("14", run_telemetry)
    fleet_timings = phase("15", run_fleet)
    serve_timings = phase("16", run_serve)
    refs = phase("17-18 references", sharded_references)
    sharded_timings = phase("17", run_sharded, card, refs)
    rumor_timings = phase("18", run_rumor_axis, card, refs)
    fleet_mesh_timings = phase("19", run_fleet_mesh, card)
    log(f"phase walls, s: {walls}")
    # S1 runs on both sim paths: its launches are the sum of their runs
    life_launches = life_timings["lifecycle"]["launches"]
    for rec, key in zip(delta_kernels, ("row_reduce", "popcount_rows")):
        rec["launches_by_path"] = {"delta_shift": rec["launches"], "lifecycle": life_launches[key]}
        rec["launches"] += life_launches[key]
    # fold_in is a T1 entry that only the fullview path draws
    tf_kernels[0]["fold_in_launches_on_fullview"] = fv_timings["fullview"]["loss1k"]["launches"]["fold_in"]
    kernels += delta_kernels + life_kernels + tf_kernels + fv_kernels + tel_kernels
    # phase 15's paths run L1, L2, S1, T1, P1, D1 and R1 once a replica: their counts there
    by_name = {"lifecycle_slot_walk": "slot_walk", "lifecycle_first_live_learner": "first_live_learner",
               "packbits_row_reduce": "row_reduce", "threefry": "threefry",
               **{name: name for name in FLEET_KERNELS if name.startswith("telemetry_")}}
    for rec in kernels:
        if rec["name"] in by_name:
            rec["launches_on_fleet"] = {path: fleet_timings["fleet"][path]["launches"][by_name[rec["name"]]]
                                        for path in ("15a", "15b", "15c")}
    timings.update(delta_timings)
    timings.update(life_timings)
    timings.update(tf_timings)
    timings.update(fv_timings)
    timings.update(tel_timings)
    timings.update(fleet_timings)
    # phase 17 runs S1, S2, L1, L2 and D1 on every rank's block: their counts by cell and rank
    for rec in kernels:
        if rec["name"] in SHARD_KERNELS.values():
            key = next(k for k, v in SHARD_KERNELS.items() if v == rec["name"])
            rec["launches_on_sharded"] = {cell: [c[key] for c in cells["launches_per_rank"]]
                                          for cell, cells in sharded_timings["sharded"]["cells"].items()}
    # phase 18 runs S1, S2, L1, L2, P1, D1 and R1 on every rank's block: their counts by cell and rank
    for rec in kernels:
        if rec["name"] in RUMOR_KERNELS.values():
            key = next(k for k, v in RUMOR_KERNELS.items() if v == rec["name"])
            rec["launches_on_rumor_axis"] = {cell: [c[key] for c in cells["launches_per_rank"]]
                                             for cell, cells in rumor_timings["rumor_axis"]["cells"].items()}
    # phase 19 runs S1, L1, L2, P1, D1 and R1 on every rank's block: their counts by cell and rank
    for rec in kernels:
        if rec["name"] in RUMOR_KERNELS.values():
            key = next(k for k, v in RUMOR_KERNELS.items() if v == rec["name"])
            rec["launches_on_fleet_mesh"] = {cell: [c[key] for c in cells["launches_per_rank"]]
                                             for cell, cells in fleet_mesh_timings["fleet_mesh"].items()
                                             if cell != "card"}
    timings.update(serve_timings)
    timings.update(sharded_timings)
    timings.update(rumor_timings)
    timings.update(fleet_mesh_timings)
    timings["card"] = card
    timings["phase_walls_s"] = walls
    # the whole record, which the end of a long log may not hold
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_timings.json").write_text(json.dumps({"timings": timings, "kernels": kernels}))
    log(json.dumps(timings))
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run(dev: torch.device, n_servers: int, n_keys: int) -> tuple[list, dict]:
    """Phases 1-4 on ``dev``; returns the kernels' records and the timings."""
    max_err = phase1_kernel_vs_plain(dev)

    # host-side set-up (not the device path): servers, keys, host oracles
    rng = np.random.default_rng(SEED + 1)
    servers = [f"10.0.{i // 256}.{i % 256}:3000" for i in range(n_servers)]
    mat, lens = uuid_keys(rng, n_keys)
    t0 = time.perf_counter()
    host_hashes = fingerprint32_batch(mat, lens)
    log(f"setup: numpy farm hashed {n_keys} keys in {time.perf_counter() - t0:.1f} s")
    sample = np.sort(rng.choice(n_keys, size=min(N_SAMPLE, n_keys), replace=False))
    dmat, dlens = upload_keys(mat, lens, dev)

    # -- the main path: launch counts are 0 before it and read right after --
    hash_kernel.reset_launches()
    t0 = time.perf_counter()
    tokens, owners = build_ring_tokens(servers, REPLICAS, device=dev)
    check(tokens.shape[0] == n_servers * REPLICAS, f"ring holds {n_servers} x {REPLICAS} tokens")
    log(f"phase2: built the {tokens.shape[0]}-token ring in {time.perf_counter() - t0:.1f} s")
    got = keyed_owner_lookup(tokens, owners, dmat, dlens)
    want = host_owner(as_np(tokens), as_np(owners), host_hashes)
    check(np.array_equal(as_np(got), want), "keyed_owner_lookup owners == host searchsorted")
    check(hash_kernel.launches == 1, f"one kernel launch per keyed lookup, saw {hash_kernel.launches}")
    log(f"phase2: {n_keys} keys -> owners equal the host oracle")

    t0 = time.perf_counter()
    store = RingStore(servers, replica_points=REPLICAS, device=dev)
    check(store.capacity == 2 * n_servers * REPLICAS, "store capacity is 2x the tokens")
    log(f"phase3: RingStore built in {time.perf_counter() - t0:.1f} s, capacity {store.capacity}")
    hashes = hash_kernel.fingerprint32(dmat, dlens)
    check(np.array_equal(as_np(hashes), host_hashes.astype(np.int64)), "kernel hashes == numpy farm")

    def certify(ring, gen, host_tokens, host_owners, ns) -> None:
        fused = as_np(serve_lookup_fused(ring, hashes))
        check(fused.shape == (n_keys + 1,), "fused output is int32[B+1]")
        check(int(fused[-1]) == gen, f"fused tail slot holds generation {gen}")
        check(
            np.array_equal(fused[:-1], host_owner(host_tokens, host_owners, host_hashes)),
            f"serve_lookup_fused owners == host oracle at gen {gen}",
        )
        fused_n = as_np(serve_lookup_n_fused(ring, ns, hashes, 3))
        check(int(fused_n[-1]) == gen, f"LookupN tail slot holds generation {gen}")
        rows = fused_n[:-1].reshape(n_keys, 3)
        check((rows >= 0).all(), "every key has 3 owners")
        oracle = host_lookup_n(host_tokens, host_owners, host_hashes[sample], 3, ns)
        check(np.array_equal(rows[sample], oracle), f"serve_lookup_n_fused == host walk at gen {gen}")
        log(f"phase3: gen {gen}: fused owners and LookupN(3) rows equal the host oracles")

    ring0, gen0, ns0 = store.snapshot()
    ht0, ho0, _, _ = store.snapshot_host()
    certify(ring0, gen0, ht0, ho0, ns0)
    n_churn = max(1, n_servers // 100)
    added = [f"10.9.{i // 256}.{i % 256}:3000" for i in range(n_churn)]
    t0 = time.perf_counter()
    record = store.update(add=added, remove=servers[:n_churn])
    log(f"phase3: {n_churn}-server churn committed in {time.perf_counter() - t0:.2f} s: "
        f"gen {record['gen']}, {record['count']} tokens, reallocated {record['reallocated']}")
    ring1, gen1, ns1 = store.snapshot()
    ht1, ho1, _, _ = store.snapshot_host()
    check(gen1 == 1 and ns1 == n_servers, f"churn commit is generation 1 at {n_servers} servers")
    certify(ring1, gen1, ht1, ho1, ns1)
    old = as_np(serve_lookup_fused(ring0, hashes))
    check(int(old[-1]) == 0 and np.array_equal(old[:-1], host_owner(ht0, ho0, host_hashes)),
          "the generation-0 snapshot survives one commit")
    launches = hash_kernel.launches
    by_route = dict(hash_kernel.route_launches)
    check(launches > 0 and by_route["staged"] == launches,
          f"the main path launched the staged Fingerprint32 kernel: {by_route}")
    log(f"main path: fingerprint32 launches = {launches} {by_route}")

    # -- timings and the full-size kernel-vs-plain check (not counted) --
    plain = fingerprint32_device(dmat, dlens)
    max_err = max(max_err, int((hashes - plain).abs().max()))
    check(torch.equal(hashes, plain), "kernel == plain on the main path's keys")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    p_ms = time_ms(lambda: fingerprint32_device(dmat, dlens), 10, flush)
    keyed_ms = time_ms(lambda: keyed_owner_lookup(tokens, owners, dmat, dlens), 10, flush)
    lookup_ms = time_ms(lambda: ring_lookup(tokens, owners, hashes), 10, flush)
    serve_ms = time_ms(lambda: serve_lookup_fused(ring1, hashes), 10, flush)
    serve_n_ms = time_ms(lambda: serve_lookup_n_fused(ring1, ns1, hashes, 3), 10, flush)
    del flush
    profile = kernel_profile(dev)
    main = profile[str(dmat.shape[1])]
    timings = {
        "timings_ms": {
            "fingerprint32_kernel_alone": main["kernel_ms"],
            "fingerprint32_call": main["call_ms"], "fingerprint32_plain": p_ms,
            "keyed_owner_lookup": keyed_ms, "ring_lookup": lookup_ms,
            "serve_lookup_fused": serve_ms, "serve_lookup_n_fused_n3": serve_n_ms,
        },
        "keys": n_keys, "key_width": int(dmat.shape[1]), "ring_tokens": int(tokens.shape[0]),
        "keyed_lookup_keys_per_s": n_keys / (keyed_ms / 1e3),
    }
    kernels = [{
        "name": "fingerprint32",
        "route": "cuda",
        "source": "ringpop_tpu_torch/csrc/fingerprint32.cu",
        "replaces": "ringpop_tpu/ops/hash_pallas.py:122",
        "launches": launches,
        "launches_by_route": by_route,
        "max_abs_err": max_err,
        "ms": main["kernel_ms"],
        "call_ms": main["call_ms"],
        "plain_ms": p_ms,
        "bound_ms": main["bound_ms"],
        "share_of_bound": main["share_of_bound"],
        "bound_by": "bytes",
        "library_ms": None,
        "by_width": {w: {k: v for k, v in rec.items() if k != "kernels"}
                     for w, rec in profile.items()},
    }]
    return kernels, timings


if __name__ == "__main__":
    sys.exit(main())
