#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (nmc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script exits
non-zero without printing a result:
  1. device    — a CUDA card must be present (else exit 1); prints
                 `nvidia-smi --query-gpu=name,power.limit` for it;
  2. build     — builds every csrc/*.cu with nvcc, one process per source,
                 all at once (first use), and beside them the sequential
                 kernel's chain-floor variant (phase 4b), and reports
                 seconds; the
                 tensor-core SASS lines of each K6 / K7 kernel
                 (`cuobjdump -sass`: HMMA, IMMA, HGMMA, IGMMA, which must
                 be there) with its ptxas registers and spills;
  3. kernel    — K1 (colored_sweeps, the neighbour-list body with P
                 replicas per CTA) on +-J and Gaussian chimera 8x8 (n_pad
                 640) and +-J ea_2d L = 32 (n_pad 1024), R = 256 and 253,
                 T = 16, an "all" and a "heated backbone + per-chain mask"
                 case, identical injected uniforms: bit for bit against
                 `neighbor_sweeps_reference` at every (P, width) that
                 `k1_launch` returns and at P = 1 at every width, and
                 against its dense plain version within its tolerance;
                 then K1's own Philox draws against the enumerated
                 Boltzmann law of a 4-cycle;
  4. streamed_kernels — K3 (colored_sweeps_sparse) on chimera 16x16
                 (n_pad 2048) and K2 (colored_sweeps_streamed) on a random
                 3-regular +-J graph with N = 4096, one kernel body over a
                 neighbour layout (`SweepNeighbors`), each at R = 256,
                 T = 16 with identical uniforms, in an "all" and a "heated
                 clusters + beta_row" case: against its plain version
                 (dense rows / tiles) within its tolerance, and bit for bit
                 against `neighbor_sweeps_reference` (the plain sweeps over
                 the layout with the kernel's association) at every CTA
                 width; the same bit for bit, K2 and K3 each, on Gaussian
                 chimera 8x8 and 16x16; K1 (several replicas per CTA) = K2
                 = K3 bit for bit with their own Philox draws on +-J and
                 Gaussian chimera 8x8; the Boltzmann TV of K2 and K3;
  4b. sequential_kernel — the sequential route (`sequential_sweeps`,
                 csrc/sequential_sweeps.cu: JAX's blocked sweep, an
                 in-block chain per warp, one phi update per block; the XLA
                 sweep run_sweeps(within_block="sequential") on the card)
                 with injected uniforms, recorded: bit for bit against its
                 association twin `sequential_sweeps_reference` on every
                 case; bit for bit against run_sweeps on +-J SK-1000 (n_pad
                 1024) at R = 64, within `_compare`'s tolerance on an
                 uncoloured Gaussian chimera 8x8 at R = 256, the recorded M
                 against run_sweeps'; the same at the slice's own launches:
                 ShardedNPT's C phase on +-J SK-1000 (R = 32, 64 sweeps,
                 per-spin heated beta, the NMC slots' masks; bit for bit)
                 and the contrived ICM round (R = 320, 576 sweeps, per-slot
                 beta; run_sweeps over its first 8); +-J SK-1000 in blocks
                 of 256 (sub-blocks of 128 in the kernel; bit for bit); the
                 batched entry (`sequential_sweeps_batched`) on 4 +-J
                 SK-1000 x 64 bit for bit against its twin and run_sweeps,
                 and with its own Philox draws against per-instance
                 launches; its Philox
                 draws against the Boltzmann law of a 4-cycle; ms per call
                 of the route and the plain version beside the bound and
                 the chain floor (a patched copy: the in-block chain one
                 spin a round, no phi update) at EnsemblePT's
                 single-instance launch (Gaussian SK-1000, R = 64 x 16)
                 and on the chimera (R = 256 x 16);
  5. nmc_512   — nmc_run on chimera 8x8, 256 chains, reduced depth, through
                 K1 (launch count of that run); plus the NMC cycle loop at a
                 small size on the card against the CPU path;
  6. nmc_2048  — nmc_run on chimera 16x16, 256 chains, edge-message LBP,
                 reduced depth, through K3;
  7. npt_2048  — apt_preprocess builds a beta ladder on chimera 16x16 and
                 npt_run exchanges replicas on it (two NMC replicas), every
                 sweep through K3 (the plain replicas with a per-replica
                 beta_row);
  8. nmc_4096  — nmc_run on the 3-regular N = 4096 graph, through K2;
  9. round_kernels — K4 (ensemble_round) on 4 chimera 8x8 instances and K5
                 (ensemble_round_sparse) on 2 chimera 16x16 instances, R = 32,
                 6 NMC slots with ~50% backbones, a geometric beta_row, 3
                 cycles of 8 sweeps, each against its plain version and
                 against the plain round over its neighbour layout (the
                 kernels' association) with identical injected uniforms;
                 K4 = K5 bit for bit with their own Philox draws on the +-1
                 8x8 family and on a Gaussian-coupled one; the kernel's
                 registers, shared memory and resident CTAs per SM at both
                 shapes (ptxas and the CUDA runtime); the Boltzmann TV of
                 each, chaining rounds on an enumerable 4-cycle; and K4 and
                 K5 at the ICM ensemble's shape (2 instances x 320 slots),
                 pure ICM (no masks) and hybrid masks, against their plain
                 versions and the plain round over their layout;
 10. ensemble_512 — EnsembleNMC at the campaign defaults on 20 chimera 8x8
                 instances (32 replicas, 6 NMC slots, planes LBP every 8
                 rounds), 16 rounds in 2 chunks, through K4; bests against
                 their f64 energies, the per-round split into LBP refresh,
                 round kernel and swaps;
 11. ensemble_2048 — the same on 20 chimera 16x16 instances through K5, 8
                 rounds;
 12. campaign  — `python -m nmc_tpu_torch campaign --arm nmc` (in process) on
                 a small chimera family written in the reference's format
                 with ground states by enumeration: through K4, every
                 instance a hit, the records parse;
 12b. round_routing — not a main path: EnsembleNMC(round_kernel="auto") on
                 4 random 3-regular N = 2048 instances (colored, n_pad
                 2560) takes K5, and with a tile layout that has no empty
                 column tile K4 over dense J; 2 rounds through each, the
                 launches counted, bests against their f64 energies;
 12c. ensemble_icm_512 — EnsembleICM (the campaign's icm arm) at its
                 defaults on 20 chimera 8x8 instances: 32 rungs x 10
                 sub-replicas = 320 slots per instance, 576 sweeps per
                 round through K4, batched device Houdayer moves ("auto":
                 the neighbour index table), 16 rounds in 2 chunks; the
                 launches, bests against their f64 energies, every
                 (instance, sub) label map a permutation, Houdayer moves
                 made, the per-round split round / houdayer / swaps, and
                 one K4 round alone (CUDA events) beside its bound;
 12d. ensemble_icm_2048 — the same on 20 chimera 16x16 instances through
                 K5, 8 rounds;
 12e. houdayer — not a main path: 3200 pairs of the 12d run's final states:
                 the labels of the sparse, blocked and matmul backends (and
                 the dense one on 16 pairs) equal bit for bit and equal the
                 host components' minima; the moves from injected uniforms
                 equal the CPU port's; ms and fixed-point iterations of
                 each backend;
 12f. hybrid_512 — the hybrid arm (hybrid_cold 6) on 20 chimera 8x8, 8
                 rounds through K4: heated chains, masks within
                 max_heat_frac;
 12g. campaign_icm — the campaign CLI's icm, hybrid (K4) and icm_host (K1)
                 arms in process on the family of phase 12: every instance
                 a hit;
 12h. apt_icm — the icm CLI at its defaults (8 rungs x 10 sub-replicas,
                 10000 sweeps, 100 swap rounds) on chimera 8x8 with host
                 ICM through K1 and chimera 16x16 with --device-icm through
                 K3: 200 sweep launches each, the best against its f64
                 energy, Houdayer moves made;
 12i. spectral — not a main path: the host spectral search at the portfolio's
                 defaults (the difference-map pool of 2048 starts x 3000
                 steps, the 2-flip polish of 8) on wishart_planted(40, 0.5)
                 against spectral_candidates_device on the card at the
                 same pool: both at the planted energy, every device
                 candidate 1-flip stable in f64, host and device seconds;
                 the device candidates without the pool on chimera 16x16;
 12j. solve_wishart — `python -m nmc_tpu_torch solve` at its defaults (in
                 process) on that instance in a wishart folder with its
                 gs_energies.txt: presolve + spectral, a hit, the JAX
                 package's record keys, no kernel launch;
 12k. solve_contrived — `portfolio_solve` on contrived_wishart_backbone(50,
                 0.2) (350 spins, core 50), no target, one MCMC round
                 (uncoloured: the plain route, its sweeps one
                 sequential_sweeps launch): the presolve's core,
                 energy_raw the f64 energy of the full-space state;
 12l. solve_chimera2048 — `solve --kind chimera --sweeps 11520 --dm-starts
                 0` on chimera_graph(16, 16) in the chimera dialect:
                 presolve, the icm arm through K5 (20 launches for 20
                 rounds), the tree stage; each stage's seconds and the MCMC
                 stage's host spectral seeding;
 12m. refine_128 — the `refine` command on chimera_graph(4, 4) from a random
                 state, its target the exact tropical DP: a hit, moves > 0;
 12n. campaign_spectral — the campaign CLI in process: the icm arm with
                 --init spectral --presolve on phase 12's family (K4), the
                 spectral arm on three planted wisharts at N = 40, the icm
                 arm with --init file from the first run's saved states
                 (K4): every instance a hit;
 12o. beam_parity — not a main path: the device beam's DP (`run_beam`,
                 torch's stable sorts) on the card against the same code on
                 CPU tensors, bit for bit in (E_fin, parents, combos), on
                 +-J chimera 4x4 at beam 2^12 and 8x8 at 2^10, split 1 and
                 2; the unpruned 4 x 3 grid at beam 2^16 (Gaussian
                 couplings on the 1/75 grid): e_int equal to the exact
                 tropical DP's;
 12p. beam_2048 — `python -m nmc_tpu_torch beam` (in process, on the card)
                 on a chimera 16x16 with couplings on the 1/75 grid: --beam
                 16 and 17 (split 2) with --no-refine, and 16 with window-8
                 strip refinement; each record's energy the f64 energy of
                 its saved state, no kernel launch, peak device memory;
                 then the device DP alone at 2^16 and 2^17: ms per cell
                 and the stable sorts' share (CUDA events);
 12q. evaluate_512 — `python -m nmc_tpu_torch evaluate --coloring` (in
                 process) on three +-J chimera 8x8 in a chimera folder
                 whose targets the device beam wrote, at its defaults and
                 at 100000 sweeps (a hit required there): K1, finite
                 energies, the hit rates;
 13. exact_kernels — K6 (mitm_min) and K7 (mitm_min_i8) against their plain
                 versions at N = 32 (a = 16, TA = 2^15, TB = 2^16) on
                 integer-coupled instances, min and argmin equal element for
                 element, pad rows included (a block_a = 384 call pads TA):
                 a planted integer wishart, a tie-heavy +-1/0 instance, and
                 K7 with 3 digit planes on an instance whose bound lies in
                 (2^24, 2^29) (where planes="off" must raise); K6 = K7 bit
                 for bit where the bound is below 2^24;
 14. exact_40  — `python -m nmc_tpu_torch exact <file> --backend pallas` (in
                 process) at N = 40 on two planted wisharts written in the
                 reference's format with gs_energies.txt, each planted at a
                 random state: float couplings through K6, integer
                 couplings through K7 and again with --planes off through
                 K6 (equal energy); each matches its planted ground state,
                 state and energy, and prints its split (host tables,
                 upload, kernel, verification); the torch-tile tier
                 (--backend device) on the integer one for comparison;
 14b. exact_enum — `solve_exact_enum` (host: the g++-built enum.cpp) on
                 exact_40's float instance: proved, at the energy K6 gave;
                 nodes and seconds;
 15. exact_tiers — the `exact` command through each tier (host, torch tiles
                 at two tilings, fused kernels, auto) on integer planted
                 wisharts at N = 28-40: the crossover `auto` follows;
 16. throughput — spin-flip attempts/s of each sweep and round kernel and its
                 plain version in turns (K1 at bench.py's configuration,
                 R = 2048, 1024 sweeps; K3 and K2 at R = 2048, 256 sweeps; K4
                 and K5 at the ensemble configurations, one 576-sweep round
                 per launch), CUDA events; each kernel's flips per attempt,
                 and the least time the card could take for the same work;
                 K6 and K7 per call at N = 40 (2^39 table entries) on the
                 main path's integer instance, on operands packed once,
                 with their plain versions (each output held against the
                 kernel's, element for element), bounds on the tensor
                 cores and the CUDA cores, registers, shared memory and
                 CTAs per SM; K6 on the float instance against its plain
                 version with a stated tolerance; K1, K2 and K3 alone
                 at the shapes they launch at on the main paths
                 (LAUNCH_SHAPES: K3 at R = 256, 64, 24 and 2), beside
                 their bounds, with each shape's replicas per CTA, width,
                 registers and CTAs per SM; and K2 against K1 (bit for
                 bit, then each timed) on a denser colored layout, 32
                 random matchings at N = 4096.
Then, after 12h, three phases of the single-card modules on the sequential
route:
 12h2. compat — the reference-compatible shims on the card on
                 chimera_graph(4, 4) (128 spins), uncoloured: NMC.run,
                 APT_preprocessor.run, NPT.run on its ladder and
                 APT_ICM.run at reduced sweeps, each through
                 sequential_sweeps and no other kernel; shapes, seconds,
                 launches, the PNGs written or warned about (no matplotlib);
 12h3. ensemble_pt — EnsemblePT on 100 SK-1000 instances x 64 replicas
                 (BASELINE config 5 on one card), 1 + 2 rounds of 32
                 sweeps, one sequential_sweeps_batched launch a round for
                 every instance; seconds per round; best energies against
                 the f64 energies of the best states; one round's launch
                 alone beside its bound, and on injected uniforms bit for
                 bit against its plain twin (timed: the kernels line's
                 plain_ms);
 12h4. native_clusters — not a main path: the g++-built union-find
                 against scipy on 3200 disagreement pairs at chimera 16x16:
                 equal partitions, both times.
After 15, the multi-GPU slice:
 15b. sharded_offsets — not a main path: K1, K2, K3 and sequential_sweeps
                 on the two replica halves of a ladder with their replica
                 offsets and the whole launch's seed words, K4 / K5
                 (4 chimera 8x8 / 16x16 instances x 32 slots) on two
                 replica and two instance halves, and
                 sequential_sweeps_batched (4 SK-1000 x 32) on two
                 instance halves with their seed words: bit for bit the
                 rows of the whole launch, and a half without its offset
                 (the batched entry: on other seed words) differs;
 15c. sharded_npt — the slice's main path: `python -m nmc_tpu_torch
                 sharded` in process on an NCCL process group of world
                 size 1 at the CLI's defaults (32 replicas, 64 sweeps a
                 phase, 3 cycles), cut in rounds: chimera 16x16 with
                 --coloring --nmc-coldest 4 (4 rounds, one K5 launch each
                 over 1 x 32 slots) and SK-1000 with --nmc-coldest 2 (2
                 rounds, 9 sequential_sweeps launches each); each record
                 against the f64 energy of its best state, launches,
                 seconds per round split lbp / round / swaps, and one K5
                 launch alone beside its bound;
 15d. sharded_ranks — not a main path: 2 ranks on this card (fresh
                 interpreters, gloo over CUDA tensors), each running
                 `sharded_rank_suite` (dryrun_multirank; ShardedNPT on
                 chimera 16x16 through K5 and SK-1000 through the
                 sequential route; SpinShardedSweeper on ea_2d(64); the
                 ensembles on the ensemble_512 family and 4 SK-1000),
                 every result bit for bit equal to the parent's world-1
                 run on the NCCL group.
Phases 5-8, 10-12, 12c, 12d, 12f-12h, 12h2, 12h3, 12j-12n, 12p, 12q, 14
and 15c are the main paths:
each sets the launch counts to 0 just before it and reads them just after. Then one
line {"kernels": [...]}, the card's name and power limit, and last
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --round-ablation
    python3 chip_smoke.py --exact-ablation
    python3 chip_smoke.py --sweep-ablation
    python3 chip_smoke.py --sequential-ablation
    python3 chip_smoke.py --sweep-times [CHECKOUT] [--sequential]

time patched copies of the round kernels', the exact kernels', the
sweep body's and the sequential kernel's sources against the kernels as
they are, in turns (ROUND_ABLATIONS, EXACT_ABLATIONS, SWEEP_ABLATIONS,
SEQ_ABLATIONS; the sweep ablation also each replicas-per-CTA and width
pair of K1 at R = 256 x 500 and 2048 x 1024, each CTA width of K2/K3 at
their launch shapes and block steps; the sequential one each
replicas-per-CTA count at EnsemblePT's single-instance launch and on the
uncoloured chimera, and EnsemblePT's batched launch);
`python3 chip_smoke.py --ranks W` runs `sharded_rank_suite` on W ranks,
one card each, over NCCL, and holds every result bit for bit against
world 1 (it needs W cards).
`--sweep-times` times K1-K3 alone at their launch and throughput shapes
and K4/K5 a round at their launches, at each CTA width (not with
`--sequential`), then the sequential route
at EnsemblePT's single-instance launch, on the uncoloured chimera 8x8
and at the contrived ICM round's launch, EnsemblePT's seconds per round
and the compat shims' seconds, with the chip_smoke.py and package of
CHECKOUT (default: this one), to compare two checkouts in turns on one
card.
"""

import contextlib
import functools
import json
import subprocess
import sys
import time

import numpy as np

TEMP_X = 20.0
R_CHECK, T_CHECK = 256, 16
HOT_BETA = 0.25
# Work counted in a kernel's bound: per attempt one Philox-4x32-10 (10 rounds
# of 2 mul, 2 mulhi, 4 xor and 2 add) and ~10 operations for the draw (the
# beta product, tanhf counted as one, p_up, the compare, dm); per flip one
# FMA (2 operations) per nonzero coupling of the row; per sweep 3 per spin
# for the energy. The H100's published peak rates give no integer rate, so
# all of it is held against the f32 rate outside the tensor cores.
OPS_PER_ATTEMPT = 110
PEAK_F32_OPS = 67e12        # H100 SXM, FP32 outside the tensor cores
PEAK_BF16_OPS = 989e12      # H100 SXM, bf16 tensor cores, dense
PEAK_INT8_OPS = 1979e12     # H100 SXM, int8 tensor cores, dense
PEAK_HBM_BYTES = 3.35e12    # H100 SXM, HBM3
DEVICE = "cuda"


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's record also gets the seconds since the
    script started (`at_seconds`), which give each phase's share."""
    if isinstance(obj, dict) and "phase" in obj:
        obj = {**obj, "at_seconds": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def _per_round(timings):
    """A flushed `timings` dict of an engine's rounds (its stage seconds
    and counters) over its own "rounds"; per-round lists left out."""
    n = timings["rounds"]
    return {k: v / n for k, v in timings.items()
            if k != "rounds" and not isinstance(v, list)}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _wrappers():
    from nmc_tpu_torch.ops import exact_cuda as ec
    from nmc_tpu_torch.ops import round_cuda as rc
    from nmc_tpu_torch.ops import swaps_cuda as sw
    from nmc_tpu_torch.ops import sweeps_cuda as sc
    return {"colored_sweeps": sc.colored_sweeps,
            "colored_sweeps_streamed": sc.colored_sweeps_streamed,
            "colored_sweeps_sparse": sc.colored_sweeps_sparse,
            "sequential_sweeps": sc.sequential_sweeps,
            "sequential_sweeps_batched": sc.sequential_sweeps_batched,
            "ensemble_round": rc.ensemble_round,
            "ensemble_round_sparse": rc.ensemble_round_sparse,
            "mitm_min": ec.mitm_min, "mitm_min_i8": ec.mitm_min_i8,
            "label_swaps": sw.label_swaps}


def reset_counts():
    for w in _wrappers().values():
        w.launches = 0


def read_counts():
    return {name: w.launches for name, w in _wrappers().items()}


def others(counts, *kernels):
    """The counts of every kernel but `kernels`."""
    return {k: v for k, v in counts.items() if k not in kernels}


# label_swaps launches of the main paths, summed for the kernels line
MAIN_PATH_SWAPS = {"launches": 0}


def check_swaps(counts, rounds, tag, main=True):
    """One label_swaps launch an engine round, in the counts of a phase's
    runs (reset just before them); a main path's add to the kernels line's
    sum. Returns the launches."""
    n = counts["label_swaps"]
    check(n == rounds, f"{tag}: label_swaps launched {n} times for "
          f"{rounds} engine rounds")
    if main:
        MAIN_PATH_SWAPS["launches"] += n
    return n


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return card


def phase_build():
    """Build every csrc/*.cu (one nvcc each, all at once) and, beside
    them, the sequential kernel's chain-floor variant
    (`_chain_floor`'s patched copy), which it returns."""
    from concurrent.futures import ThreadPoolExecutor
    from nmc_tpu_torch.ops import _build
    cached = {n: _build.library_path(n).exists() for n in _build.sources()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        floor = pool.submit(_variant_library, "chain_floor",
                            "sequential_sweeps", ["sweep_common.cuh"],
                            SEQ_ABLATIONS["chain_floor"])
        paths = _build.build_all()
        for name in paths:
            _build.load_library(name)
        floor = floor.result()
    seconds = time.perf_counter() - t0
    ptxas = {}
    for name, path in paths.items():
        log = path.with_suffix(".log")
        ptxas[name] = ([ln.strip() for ln in log.read_text().splitlines()
                        if "registers" in ln or "spill" in ln or "smem" in ln]
                       if log.exists() else [])
    sass = _tensor_core_sass(paths["exact_mitm"])
    for kind, ops in (("K6", ("HMMA", "HGMMA")), ("K7", ("IMMA", "IGMMA"))):
        kernels = {k: v for k, v in sass.items() if k.startswith(kind)}
        check(kernels and all(sum(v.get(op, 0) for op in ops) > 0
                              for v in kernels.values()),
              f"{kind}: no tensor-core instructions in {kernels}")
    emit({"phase": "build", "libraries": sorted(p.name for p in paths.values()),
          "cached": cached, "seconds": seconds, "ptxas": ptxas,
          "exact_mitm_tensor_core_sass": sass})
    return floor


def _tensor_core_sass(lib):
    """Per kernel of a built library, its count of tensor-core SASS lines
    (HMMA, IMMA, HGMMA, IGMMA) from `cuobjdump -sass`, with the registers,
    spills and shared memory of its ptxas report. Kernels are keyed K6 /
    K7 and their template argument (K6's k-steps, K7's digit planes)."""
    import os
    import re
    from nmc_tpu_torch.ops import _build
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()),
                             "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    log = lib.with_suffix(".log").read_text()
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = _kernel_key(line.split("Function :")[1].strip())
            counts[name] = {}
        elif name:
            for op in ("HGMMA", "IGMMA", "HMMA", "IMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[name][op] = counts[name].get(op, 0) + 1
                    break
    # ptxas reports each entry function, then its stack / spills and its
    # registers and shared memory
    mangled = None
    for line in log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            mangled = _kernel_key(m.group(1))
        elif mangled in counts and ("spill" in line or "registers" in line):
            counts[mangled].setdefault("ptxas", []).append(
                line.replace("ptxas info    :", "").strip())
    return counts


def _kernel_key(mangled):
    for op, kind in (("F32OpILi", "K6_ksteps_"), ("I8OpILi", "K7_planes_")):
        if op in mangled:
            i = mangled.index(op) + len(op)
            return kind + mangled[i:mangled.index("E", i)]
    return mangled



# ---- instances -------------------------------------------------------------

def _flagship():
    """bench.py's fallback instance: chimera C(8,8,4), +-J, normalized."""
    from nmc_tpu_torch.io.generators import chimera_graph
    from nmc_tpu_torch.ops.engine import SweepEngine
    prob = chimera_graph(8, 8, seed=0).normalized()[0]
    eng = SweepEngine(prob, use_coloring=True, device=DEVICE)
    check(eng.n_pad == 640 and eng.sweep_kernel == "colored_sweeps",
          f"expected a colored n_pad=640 K1 layout, got {eng.n_pad}")
    return prob, eng


def _chimera2048():
    """chimera C(16,16,4), +-J, normalized: the K3 layout."""
    from nmc_tpu_torch.io.generators import chimera_graph
    from nmc_tpu_torch.ops.engine import SweepEngine
    prob = chimera_graph(16, 16, seed=0).normalized()[0]
    eng = SweepEngine(prob, use_coloring=True, device=DEVICE)
    check(eng.n_pad == 2048 and eng.sweep_kernel == "colored_sweeps_sparse",
          f"chimera 16x16: n_pad {eng.n_pad}, route {eng.sweep_kernel}")
    return prob, eng


def _matchings(N, degree, seed, name):
    """The union of `degree` random perfect matchings with +-1 weights, from
    np.random.default_rng(seed)."""
    from nmc_tpu_torch.core.problem import IsingProblem
    rng = np.random.default_rng(seed)
    J = np.zeros((N, N))
    for _ in range(degree):
        p = rng.permutation(N)
        a, c = p[:N // 2], p[N // 2:]
        w = rng.choice([-1.0, 1.0], size=N // 2)
        J[a, c] = w
        J[c, a] = w
    return IsingProblem(J, np.zeros(N), name=name)


def _regular3(N=4096):
    """The union of three random perfect matchings with +-1 weights, from
    np.random.default_rng(0): the K2 layout (dense J row blocks)."""
    from nmc_tpu_torch.core.problem import block_sparse_tiles
    from nmc_tpu_torch.ops.engine import SweepEngine
    prob = _matchings(N, 3, 0, "regular3_4096")
    eng = SweepEngine(prob, use_coloring=True, device=DEVICE)
    K = block_sparse_tiles(eng.blocked)[0].shape[1]
    nB = eng.blocked.num_blocks
    check(eng.sweep_kernel == "colored_sweeps_streamed" and K > nB // 2,
          f"3-regular: route {eng.sweep_kernel}, K {K}, nB {nB}")
    return prob, eng, K


def _tiles(eng):
    """K3's col_idx and J_tiles of an engine's layout, on the card."""
    import torch
    from nmc_tpu_torch.core.problem import block_sparse_tiles
    if eng.stream_tiles is not None:
        return eng.stream_tiles
    col_idx, J_tiles = block_sparse_tiles(eng.blocked)
    return (torch.as_tensor(col_idx, dtype=torch.int32, device=DEVICE),
            torch.as_tensor(J_tiles, device=DEVICE))


def _kernel_fns(name, eng, threads=None):
    """(kernel, plain version) of one wrapper on an engine's layout, both
    taking (h, m0, phi0, generator, beta, beta_row, mask, beta_spin, *,
    num_sweeps, uniforms). The kernel runs over the engine's neighbour
    layout where it built one (K2/K3 routes), else the wrapper builds it
    from its own arrays; `threads` None takes the wrapper's width rule."""
    import functools
    from nmc_tpu_torch.ops import sweeps_cuda as sc
    if name == "colored_sweeps_sparse":
        args = _tiles(eng)
        k, p = sc.colored_sweeps_sparse, sc.colored_sweeps_sparse_reference
    else:
        args = (eng.J_rows,)
        k, p = sc.colored_sweeps_streamed, sc.colored_sweeps_streamed_reference
    return (functools.partial(k, *args, nbrs=eng.sweep_nbrs, threads=threads),
            functools.partial(p, *args))


def _bit_equal(a, b):
    """Every output of two sweep results equal element for element (==, so
    a zero's sign aside; unrecorded states None in both)."""
    import torch
    return all(x is y is None or torch.equal(x, y) for x, y in zip(a, b))


def _gaussian_chimera(size, seed=5):
    """chimera C(size, size, 4) with Gaussian couplings, normalized, and
    its engine (K1's layout at 8x8, K3's at 16x16)."""
    from nmc_tpu_torch.io.generators import chimera_graph
    from nmc_tpu_torch.ops.engine import SweepEngine
    prob = chimera_graph(size, size, seed=seed, pm=False).normalized()[0]
    return prob, SweepEngine(prob, use_coloring=True, device=DEVICE)


# ---- kernel phases -----------------------------------------------------------

def _compare(torch, name, k, p, J, h, m0, mask):
    """Kernel result k against plain result p from identical uniforms."""
    R, n_pad = m0.shape
    torch.cuda.synchronize()
    differ = (k.m != p.m).any(dim=1)
    n_diff = int(differ.sum())
    check(n_diff <= 1, f"{name}: spins differ in {n_diff} replicas")
    same = ~differ
    phi_err = float((k.phi[same] - p.phi[same]).abs().max())
    e_err = float((k.energies[:, same] - p.energies[:, same]).abs().max())
    phi_self = float((k.phi - (k.m @ J + h)).abs().max())
    check(torch.isin(k.m, torch.tensor([-1.0, 1.0], device=DEVICE)).all(),
          f"{name}: spins outside +-1")
    check(phi_self <= 1e-4, f"{name}: phi off m@J+h by {phi_self}")
    check(phi_err <= 1e-4, f"{name}: phi off the plain version by {phi_err}")
    check(e_err <= 1e-3, f"{name}: energies off the plain version by {e_err}")
    check(bool((k.e_best <= k.energies.min(dim=0).values).all()),
          f"{name}: e_best above the sweep minimum")
    check(bool((k.m_best[same] == p.m_best[same]).all()),
          f"{name}: best states differ from the plain version")
    frozen = ~mask.expand(R, n_pad)
    check(bool((k.m[frozen] == m0[frozen]).all()), f"{name}: frozen spins moved")
    check(bool((k.m[~frozen] != m0[~frozen]).any()),
          f"{name}: no free spin moved")
    return {"replicas_differing": n_diff, "phi_max_abs_err": phi_err,
            "energy_max_abs_err": e_err, "phi_vs_mJ_h": phi_self}, \
        max(phi_err, e_err)


def _ea2d32():
    """ea_2d(32, seed=0), +-J: 2 colour classes, n_pad 1024, a second K1
    layout, and its engine."""
    from nmc_tpu_torch.io.generators import ea_2d
    from nmc_tpu_torch.ops.engine import SweepEngine
    eng = SweepEngine(ea_2d(32, seed=0), use_coloring=True, device=DEVICE)
    check(eng.n_pad == 1024 and eng.sweep_kernel == "colored_sweeps",
          f"ea_2d L = 32: n_pad {eng.n_pad}, route {eng.sweep_kernel}")
    return eng


def _k1_shapes(n_pad):
    """Every (replicas per CTA, width) that k1_launch returns at this n_pad
    on this card for R = 1 .. 16384, and one replica per CTA at every
    width."""
    from nmc_tpu_torch.ops import sweeps_cuda as sc
    sms = sc._num_sms(DEVICE)
    shapes = {sc.k1_launch(R, n_pad, sms) for R in range(1, 16385)}
    return sorted(shapes | {(1, w) for w in sc.K1_WIDTHS})


def phase_kernel():
    """K1 on three layouts (+-J chimera 8x8, Gaussian chimera 8x8, +-J
    ea_2d L = 32), at R = 256 and R = 253 (not a multiple of 2, 4 or 8),
    T = 16, in an "all" case and a "heated backbone + per-chain mask" case
    with identical injected uniforms: at every (P, width) of `_k1_shapes`,
    bit for bit against `neighbor_sweeps_reference` (beta_row 1, the
    kernel's steps and association); at the rule's shape against
    `colored_sweeps_reference` (dense J row blocks, the TPU kernel's
    function) within `_compare`'s tolerance. Then K1's own Philox draws
    against the enumerated Boltzmann law of a 4-cycle."""
    import torch
    from nmc_tpu_torch.ops import sweeps_cuda as sc
    T = T_CHECK
    layouts = {"chimera512": _flagship()[1],
               "gaussian_chimera512": _gaussian_chimera(8)[1],
               "ea2d_1024": _ea2d32()}
    out = {"phase": "kernel", "kernel": "colored_sweeps", "T": T}
    max_err = 0.0
    for layout, eng in layouts.items():
        n_pad, B = eng.n_pad, eng.blocked.block_size
        shapes = _k1_shapes(n_pad)
        res = {"n_pad": n_pad, "steps": len(eng.sweep_nbrs.step_ptr) - 1,
               "shapes_bit_equal": [list(x) for x in shapes]}
        for R in (R_CHECK, R_CHECK - 3):
            gen = torch.Generator(device=DEVICE).manual_seed(1)
            m0 = eng.init_states(gen, R)
            phi0 = eng.fields(m0)
            u = torch.rand((T, R, n_pad), generator=gen, device=m0.device)
            cl = ((torch.rand((R, n_pad), generator=gen, device=DEVICE) < 0.5)
                  & eng.active)
            cases = {
                # all spins at beta = 1, as in an ALL phase
                "all": (torch.full((T,), 1.0, device=DEVICE),
                        torch.ones((), device=DEVICE), eng.active[None]),
                # an NMC C phase: the backbone heated to beta / temp_x, the
                # rest frozen
                "heated_backbone_chain_mask": (
                    torch.full((T,), 2.5, device=DEVICE),
                    torch.where(cl, 1.0 / TEMP_X, 1.0), cl)}
            rule = sc.k1_launch(R, n_pad, sc._num_sms(DEVICE))
            for case, (beta, bs, mask) in cases.items():
                args = (eng.h, m0, phi0, None, beta)
                q = sc.neighbor_sweeps_reference(
                    eng.sweep_nbrs, *args, torch.ones(R, device=DEVICE), mask,
                    None if bs.ndim == 0 else bs, num_sweeps=T, uniforms=u)
                for P, width in shapes:
                    k = sc.colored_sweeps(
                        eng.J_full, *args, bs, mask, num_sweeps=T,
                        block_size=B, uniforms=u, nbrs=eng.sweep_nbrs,
                        threads=width, replicas_per_cta=P)
                    torch.cuda.synchronize()
                    check(_bit_equal(k, q), f"K1 {layout} R={R} {case} P={P} "
                          f"width={width}: differs from the plain sweeps over "
                          "its layout")
                k = sc.colored_sweeps(eng.J_full, *args, bs, mask,
                                      num_sweeps=T, block_size=B, uniforms=u,
                                      nbrs=eng.sweep_nbrs)
                p = sc.colored_sweeps_reference(eng.J_full, *args, bs, mask,
                                                num_sweeps=T, block_size=B,
                                                uniforms=u)
                cmp, err = _compare(torch, f"K1 {layout} R={R} {case}", k, p,
                                    eng.J_full, eng.h, m0, mask)
                res[f"R={R} {case}"] = {"rule": list(rule),
                                        "vs_neighbor_plain_bit_equal": True,
                                        "vs_dense_plain": cmp}
                max_err = max(max_err, err)
        out[layout] = res

    def k1(eng, m, gen, beta, sweeps):
        return eng.run(m, gen, sweeps, beta, blocked_input=True,
                       blocked_output=True).m

    out["boltzmann_tv"] = _boltzmann_tv(torch, k1)
    check(out["boltzmann_tv"] < 0.05, f"K1 Philox TV {out['boltzmann_tv']}")
    emit(out)
    return max_err


def _sweep_cases(torch, eng, R, T, seed):
    """Random states, uniforms and the two sweep cases of a K2/K3 check:
    "all" (every active spin at beta 1) and an NMC C phase with clusters
    heated to beta / temp_x, the rest frozen, and a per-replica beta_row;
    each (beta, beta_row, mask, beta_spin)."""
    n_pad = eng.n_pad
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    m0 = eng.init_states(gen, R)
    phi0 = eng.fields(m0)
    u = torch.rand((T, R, n_pad), generator=gen, device=m0.device)
    cl = ((torch.rand((R, n_pad), generator=gen, device=DEVICE) < 0.5)
          & eng.active)
    cases = {
        "all": (torch.full((T,), 1.0, device=DEVICE),
                torch.ones(R, device=DEVICE), eng.active[None], None),
        "heated_clusters_beta_row": (
            torch.full((T,), 2.5, device=DEVICE),
            torch.linspace(0.5, 2.0, R, device=DEVICE), cl,
            torch.where(cl, 1.0 / TEMP_X, 1.0)),
    }
    return m0, phi0, u, cases


def _equals_k1(torch, eng, names, R, T):
    """K1, at the (P, width) k1_launch gives R = 2048 on this layout, and
    each wrapper of `names` (K2, K3) on one layout with one Philox seed,
    from the same random states at beta 2: every output equal element for
    element (checked). Returns K1's (P, width)."""
    from nmc_tpu_torch.ops import sweeps_cuda as sc
    P, width = sc.k1_launch(2048, eng.n_pad, sc._num_sms(DEVICE))
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    m0 = eng.init_states(gen, R)
    phi0 = eng.fields(m0)
    beta = torch.full((T,), 2.0, device=DEVICE)
    k1 = sc.colored_sweeps(
        eng.J_full, eng.h, m0, phi0,
        torch.Generator(device=DEVICE).manual_seed(7), beta,
        torch.ones((), device=DEVICE), eng.active[None], num_sweeps=T,
        block_size=eng.blocked.block_size, nbrs=eng.sweep_nbrs,
        threads=width, replicas_per_cta=P)
    check(bool((k1.m != m0).any()), "K1 moved no spin")
    for name in names:
        kr = _kernel_fns(name, eng)[0](
            eng.h, m0, phi0, torch.Generator(device=DEVICE).manual_seed(7),
            beta, torch.ones(R, device=DEVICE), eng.active[None], None,
            num_sweeps=T)
        check(_bit_equal(k1, kr),
              f"{name} differs from K1 with the same Philox seed")
    return {"k1_replicas_per_cta": P, "k1_threads": width}


def phase_streamed_kernels(c2048, r4096):
    """K3 and K2 against their plain versions (within today's tolerances)
    and, bit for bit, against the plain sweeps over their neighbour layout
    with the kernel's association, at every CTA width; the same on
    Gaussian chimera couplings; K1 (at its R = 2048 shape, several replicas
    per CTA) = K2 = K3 with one Philox seed on +-J and Gaussian couplings;
    K2's and K3's Philox Boltzmann TV."""
    import torch
    from nmc_tpu_torch.ops import sweeps_cuda as sc
    R, T = R_CHECK, T_CHECK
    out = {"phase": "streamed_kernels", "R": R, "T": T,
           "widths": list(sc.SWEEP_WIDTHS),
           "width_rule": {r: sc.sweep_threads(r, sc._num_sms(DEVICE))
                          for r in (2, 24, 64, 256, 2048)}}
    max_err = {"colored_sweeps_streamed": 0.0, "colored_sweeps_sparse": 0.0}
    g8, g16 = _gaussian_chimera(8), _gaussian_chimera(16)
    # (kernel, layout name, engine, also against the dense/tile plain twin)
    layouts = (("colored_sweeps_sparse", "chimera2048", c2048[1], True),
               ("colored_sweeps_streamed", "regular3_4096", r4096[1], True),
               ("colored_sweeps_sparse", "gaussian_chimera512", g8[1], False),
               ("colored_sweeps_streamed", "gaussian_chimera512", g8[1],
                False),
               ("colored_sweeps_sparse", "gaussian_chimera2048", g16[1],
                False),
               ("colored_sweeps_streamed", "gaussian_chimera2048", g16[1],
                False))
    for name, layout, eng, twin in layouts:
        kernel, plain = _kernel_fns(name, eng)
        nbrs = eng.sweep_nbrs
        m0, phi0, u, cases = _sweep_cases(torch, eng, R, T, 11)
        res = {"n_pad": eng.n_pad, "num_blocks": eng.blocked.num_blocks,
               "steps": int(nbrs.step_ptr.shape[0]) - 1,
               "targets": int(nbrs.tgt.shape[0]),
               "entries": int(nbrs.src.shape[0])}
        if layout == "chimera2048":
            res["tiles_per_row_block"] = int(eng.stream_tiles[0].shape[1])
        elif layout == "regular3_4096":
            res["tiles_per_row_block"] = r4096[2]
        for case, (beta, beta_row, mask, bs) in cases.items():
            args = (eng.h, m0, phi0, None, beta, beta_row, mask, bs)
            k = kernel(*args, num_sweeps=T, uniforms=u)
            q = sc.neighbor_sweeps_reference(nbrs, *args, num_sweeps=T,
                                             uniforms=u)
            torch.cuda.synchronize()
            check(_bit_equal(k, q), f"{name} {layout} {case}: differs from "
                  "the plain sweeps over its layout")
            check(bool((k.m != m0).any()), f"{name} {layout}: no spin moved")
            res[case] = {"vs_neighbor_plain_bit_equal": True}
            if twin:
                p = plain(*args, num_sweeps=T, uniforms=u)
                cmp, e = _compare(torch, f"{name} {case}", k, p, eng.J_full,
                                  eng.h, m0, mask)
                res[case].update(cmp)
                max_err[name] = max(max_err[name], e)
            # the same outputs at every CTA width
            for w in sc.SWEEP_WIDTHS:
                kw, _ = _kernel_fns(name, eng, threads=w)
                check(_bit_equal(kw(*args, num_sweeps=T, uniforms=u), k),
                      f"{name} {layout} {case}: width {w} differs")
            res[case]["widths_bit_equal"] = True
        out.setdefault(name, {})[layout] = res

    # K1 (several replicas per CTA) = K2 = K3 with their own Philox draws on
    # one layout: one body, whatever P, so they agree on any f32 couplings
    names = ("colored_sweeps_streamed", "colored_sweeps_sparse")
    out["k1_k2_k3_bit_equal_philox"] = {
        "chimera512": _equals_k1(torch, _flagship()[1], names, R, T),
        "gaussian_chimera512": _equals_k1(torch, g8[1], names, R, T)}

    for name in ("colored_sweeps_streamed", "colored_sweeps_sparse"):
        def run(eng, m, gen, beta, sweeps, name=name):
            kernel, _ = _kernel_fns(name, eng)
            return kernel(eng.h, m, eng.fields(m), gen,
                          torch.full((sweeps,), beta, device=DEVICE),
                          torch.ones(m.shape[0], device=DEVICE),
                          eng.active[None], None, num_sweeps=sweeps).m
        tv = _boltzmann_tv(torch, run)
        check(tv < 0.05, f"{name} Philox TV {tv} >= 0.05")
        out[name]["boltzmann_tv"] = tv
    emit(out)
    return max_err


def _boltzmann_tv(torch, run):
    """A kernel with its own Philox draws on an enumerable 4-cycle with
    fields (`run(engine, m, generator, beta, sweeps)` returns the blocked
    states after `sweeps` sweeps); total variation distance of the visited
    states from Boltzmann."""
    import itertools
    from nmc_tpu_torch.core.problem import IsingProblem
    from nmc_tpu_torch.ops.engine import SweepEngine
    rng = np.random.default_rng(1234)
    n, beta = 4, 0.8
    J = np.zeros((n, n))
    for i in range(n):
        j = (i + 1) % n
        J[i, j] = J[j, i] = rng.normal()
    prob = IsingProblem(J, 0.3 * rng.normal(size=n))
    states = np.array(list(itertools.product([-1, 1], repeat=n)), float)
    p = np.exp(-beta * prob.energy(states))
    p /= p.sum()
    weights = 2 ** np.arange(n)[::-1]
    target = np.zeros(2 ** n)
    target[(((states + 1) / 2) @ weights).astype(int)] = p

    eng = SweepEngine(prob, block_size=8, use_coloring=True, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    m = eng.init_states(gen, 2048)
    counts = np.zeros(2 ** n)
    for it in range(25):
        m = run(eng, m, gen, beta, 4)
        if it >= 5:
            orig = eng.from_blocked(m).cpu().numpy()
            idx = (((orig + 1) / 2) @ weights).astype(int)
            counts += np.bincount(idx, minlength=2 ** n)
    counts /= counts.sum()
    return float(np.abs(counts - target).sum() / 2)


# ---- main paths --------------------------------------------------------------

def _nmc_main_path(prob, cfg, kernel, seed):
    """nmc_run with the launch counts set to 0 just before and read just
    after; the kernel's per-chain best energy against the f64 energy of
    the m_best it kept."""
    import torch
    from nmc_tpu_torch.models.nmc import nmc_run
    from nmc_tpu_torch.utils.metrics import MetricsLogger
    metrics = MetricsLogger()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    reset_counts()
    t0 = time.perf_counter()
    res = nmc_run(prob, cfg, gen, metrics=metrics, device=DEVICE)
    wall = time.perf_counter() - t0
    launches = read_counts()
    check(launches[kernel] > 0, f"nmc_run launched no {kernel}")
    check(all(v == 0 for k, v in launches.items() if k != kernel),
          f"nmc_run launched other kernels than {kernel}: {launches}")
    R, n = cfg.num_chains, prob.n
    check(res.m_best.shape == (R, n) and res.min_energy.shape == (R,),
          f"unexpected shapes {res.m_best.shape}, {res.min_energy.shape}")
    check(np.isin(res.m_best, [-1.0, 1.0]).all(), "m_best outside +-1")
    check(np.isfinite(res.energy_overall).all(), "non-finite sweep energies")
    # each chain's best state is the state of its lowest sweep energy over
    # all phases, so that f32 energy, reported by the kernel, must match
    # the f64 energy of the m_best it kept
    recompute = prob.energy(res.m_best)
    best_err = float(np.abs(res.energy_overall.min(axis=0) - recompute).max())
    check(best_err <= 1e-3,
          f"kernel best energies off the f64 energy of m_best by {best_err}")
    check(np.allclose(res.min_energy, recompute, rtol=0, atol=1e-9),
          "min_energy differs from the f64 recompute")
    sweeps = metrics.of_kind("sweeps")
    return res, {
        "N": n, "num_chains": R, "launches": launches[kernel],
        "wall_seconds": wall, "warmup_best": sweeps[0]["min_energy"],
        "best_energy": float(res.min_energy.min()),
        "kernel_best_vs_f64_max_abs_err": best_err,
        "phase_times": [{"phase": r["phase"], "seconds": r["seconds"],
                         "min_energy": r["min_energy"]} for r in sweeps],
        "lbp": [{"cycle": r["cycle"], "seconds": r["seconds"],
                 "cluster_spins": r["total"]}
                for r in metrics.of_kind("clusters")]}


def phase_nmc_512():
    """nmc_run on chimera 8x8 with 256 chains, through K1."""
    import torch
    from nmc_tpu_torch.models.nmc import NMCConfig
    prob, _ = _flagship()
    cfg = NMCConfig(num_sweeps_initial=2000, num_sweeps_per_NMC_phase=500,
                    num_NMC_cycles=3, num_chains=256, use_coloring=True,
                    record_m=False)
    res, out = _nmc_main_path(prob, cfg, "colored_sweeps", 0)
    # At this depth the C phase re-samples the backbone at beta/temp_x
    # (about 55% of the spins), so with few chains the NMC best can end
    # above the warm-up's; with 256 chains and these seeds it reaches it.
    check(out["best_energy"] <= out["warmup_best"],
          f"NMC best {out['best_energy']} above the warm-up best")
    emit({"phase": "nmc_512", "reduced": {
        "num_sweeps_initial": [10000, 2000],
        "num_sweeps_per_NMC_phase": [10000, 500], "num_NMC_cycles": [10, 3]},
        **out, "small_parity": _nmc_small_parity(torch)})
    return out["launches"]


def _nmc_small_parity(torch):
    """The NMC cycle loop on chimera 2x2 (block 8, 4 chains, fixed clusters)
    on the card (kernel path) and on the CPU (plain path), fed the same
    uniforms: identical best states, energies within f32 rounding."""
    from nmc_tpu_torch.io.generators import chimera_graph
    from nmc_tpu_torch.models.nmc import NMCConfig, nmc_subroutine
    from nmc_tpu_torch.ops.engine import SweepEngine
    from nmc_tpu_torch.ops.sweeps_cuda import colored_sweeps
    prob = chimera_graph(2, 2, seed=3).normalized()[0]
    cfg = NMCConfig(num_sweeps_per_NMC_phase=6, num_NMC_cycles=2,
                    record_m=False, use_coloring=True, block_size=8)
    R = 4
    rng = np.random.default_rng(5)
    m_star = np.where(rng.random((R, prob.n)) < 0.5, -1.0, 1.0)
    clusters = rng.permutation(prob.n)[:prob.n // 3]
    out = {}
    for dev in ("cuda", "cpu"):
        eng = SweepEngine(prob, block_size=8, use_coloring=True, device=dev)
        u_rng = np.random.default_rng(6)
        uniforms = [torch.as_tensor(u_rng.random(
            (cfg.num_sweeps_per_NMC_phase, R, eng.n_pad)), dtype=torch.float32,
            device=dev) for _ in range(3 * cfg.num_NMC_cycles)]
        before = colored_sweeps.launches
        out[dev] = nmc_subroutine(eng, prob, m_star, None, cfg,
                                  all_clusters=clusters, uniforms=uniforms)
        out[dev + "_launches"] = colored_sweeps.launches - before
    check(out["cuda_launches"] == 3 * cfg.num_NMC_cycles
          and out["cpu_launches"] == 0, "unexpected kernel routing")
    check(np.array_equal(out["cuda"].m_best, out["cpu"].m_best),
          "small NMC: best states differ between card and CPU")
    err = float(np.abs(out["cuda"].energy_overall
                       - out["cpu"].energy_overall).max())
    check(err <= 1e-4, f"small NMC: energies differ by {err}")
    return {"m_best_equal": True, "energy_max_abs_err": err}


def phase_nmc_2048(c2048):
    """nmc_run on chimera 16x16 with 256 chains and edge-message LBP,
    through K3."""
    from nmc_tpu_torch.models.nmc import NMCConfig
    prob, _ = c2048
    cfg = NMCConfig(num_sweeps_initial=2000, num_sweeps_per_NMC_phase=500,
                    num_NMC_cycles=3, num_chains=256, use_coloring=True,
                    record_m=False, sparse_lbp_threshold=1024)
    _, out = _nmc_main_path(prob, cfg, "colored_sweeps_sparse", 0)
    check(out["launches"] >= 1 + 3 * cfg.num_NMC_cycles,
          f"nmc_run launched K3 {out['launches']} times")
    emit({"phase": "nmc_2048", "sparse_lbp_threshold": 1024, "reduced": {
        "num_sweeps_initial": [10000, 2000],
        "num_sweeps_per_NMC_phase": [10000, 500], "num_NMC_cycles": [10, 3]},
        **out})
    return out["launches"]


def phase_nmc_4096(r4096):
    """nmc_run on the 3-regular N = 4096 graph (edge-message LBP, above the
    default threshold), through K2, at a small depth."""
    from nmc_tpu_torch.models.nmc import NMCConfig
    prob = r4096[0]
    cfg = NMCConfig(num_sweeps_initial=500, num_sweeps_per_NMC_phase=100,
                    num_NMC_cycles=1, num_chains=64, use_coloring=True,
                    record_m=False)
    _, out = _nmc_main_path(prob, cfg, "colored_sweeps_streamed", 1)
    check(out["launches"] == 1 + 3 * cfg.num_NMC_cycles,
          f"nmc_run launched K2 {out['launches']} times")
    emit({"phase": "nmc_4096", "reduced": {
        "num_sweeps_initial": [10000, 500],
        "num_sweeps_per_NMC_phase": [10000, 100], "num_NMC_cycles": [10, 1],
        "num_chains": [256, 64]}, **out})
    return out["launches"]


def phase_npt_2048(c2048):
    """apt_preprocess builds a beta ladder on chimera 16x16 with reduced
    sweeps; npt_run exchanges replicas on it, the two coldest running NMC,
    with every engine call through K3 (the plain replicas' betas as K3's
    beta_row)."""
    import torch
    from nmc_tpu_torch.models.apt import APTConfig, apt_preprocess
    from nmc_tpu_torch.models.npt import NPTConfig, npt_run
    from nmc_tpu_torch.utils.metrics import MetricsLogger
    prob, _ = c2048
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    apt_cfg = APTConfig(num_sweeps_MCMC=200, num_sweeps_read=100, num_rng=64,
                        beta_start=0.5, beta_max=3.0, use_coloring=True)
    apt_metrics = MetricsLogger()
    reset_counts()
    t0 = time.perf_counter()
    apt = apt_preprocess(prob, apt_cfg, gen, metrics=apt_metrics,
                         device=DEVICE)
    apt_seconds = time.perf_counter() - t0
    apt_launches = read_counts()
    ladder = np.asarray(apt.beta)
    L = ladder.size
    check(L >= 4 and np.all(np.diff(ladder) > 0), f"APT ladder {ladder}")
    check(apt_launches["colored_sweeps_sparse"] == len(
        apt_metrics.of_kind("apt_rung")), f"APT launches {apt_launches}")

    npt_cfg = NPTConfig(num_sweeps_MCMC=1200, num_sweeps_read=600,
                        num_swap_attempts=4,
                        num_swapping_pairs=max(1, (L - 1) // 4),
                        num_cycles=1, use_coloring=True,
                        record_last_round_m=False, lambda_start=3.0,
                        tolerance=1e-8, max_iterations=200)
    doNMC = [False] * (L - 2) + [True] * 2
    metrics = MetricsLogger()
    reset_counts()
    t0 = time.perf_counter()
    res = npt_run(prob, ladder, doNMC, npt_cfg, gen, metrics=metrics,
                  device=DEVICE)
    npt_seconds = time.perf_counter() - t0
    launches = read_counts()
    rounds = npt_cfg.num_swap_attempts
    # per round one K3 call for the plain replicas, three (C, NC, ALL) for
    # the NMC replicas' one cycle
    check(launches["colored_sweeps_sparse"] == 4 * rounds
          and launches["colored_sweeps"] == 0
          and launches["colored_sweeps_streamed"] == 0,
          f"npt_run launches {launches}")
    check(res.rounds_completed == rounds, "npt_run stopped early")
    check(np.isin(res.best_state, [-1.0, 1.0]).all(), "best state outside +-1")
    e64 = float(prob.energy(res.best_state))
    check(abs(e64 - res.min_energy) <= 1e-9, "min_energy is not the f64 one")
    kernel_best = metrics.of_kind("sweeps")[-1]["min_energy"]
    best_err = abs(kernel_best - e64)
    check(best_err <= 1e-3,
          f"NPT best {kernel_best} off the f64 energy {e64} by {best_err}")
    check(np.isfinite(res.Energy).all() and res.Energy.shape == (L,),
          "non-finite replica energies")
    emit({"phase": "npt_2048", "apt": {
        "num_rungs": L, "beta_first_last": [ladder[0], ladder[-1]],
        "launches": apt_launches["colored_sweeps_sparse"],
        "seconds": apt_seconds, "reduced": {
            "num_sweeps_MCMC": [1000, 200], "num_sweeps_read": [1000, 100],
            "num_rng": [100, 64], "beta_max": [30.0, 3.0]}},
        "npt": {"replicas": L, "nmc_replicas": 2, "rounds": rounds,
                "sweeps_per_round": npt_cfg.derived_budgets()[0],
                "launches": launches["colored_sweeps_sparse"],
                "beta_row_min_max": [ladder[0], ladder[L - 3]],
                "accepted_swaps": int(res.swap_counts.sum()),
                "attempted_swaps": rounds * npt_cfg.num_swapping_pairs,
                "best_energy_f64": e64, "kernel_best_vs_f64": best_err,
                "seconds": npt_seconds,
                "round_seconds": [r["seconds"]
                                  for r in metrics.of_kind("sweeps")]}})
    return apt_launches["colored_sweeps_sparse"] + launches[
        "colored_sweeps_sparse"]


# ---- the campaign engine: round kernels K4 / K5 -------------------------------

ENS_R, ENS_NMC = 32, 6           # the campaign's replicas and NMC slots
GLOBAL_BETA = 13.63              # the campaign's --global-beta


def _ensemble(size, count, rounds_cfg=None, seed0=0, pm=True, group=None):
    """EnsembleNMC on `count` chimera size x size instances (seeds seed0..,
    +-1 couplings, or Gaussian with pm=False), normalized, as the campaign
    builds it at its defaults: the geometric 32-replica ladder over beta
    0.25-32, the 6 coldest replicas NMC, global beta 13.63, 3 cycles of 64
    sweeps, planes LBP every 8 rounds."""
    from nmc_tpu_torch.campaign import build_ladder
    from nmc_tpu_torch.io.generators import chimera_graph
    from nmc_tpu_torch.parallel import EnsembleNMC, ShardedNPTConfig
    probs = [chimera_graph(size, size, seed=s, pm=pm).normalized()[0]
             for s in range(seed0, seed0 + count)]
    beta = build_ladder(0.25, 32.0, ENS_R)
    kw = dict(sweeps_per_phase=64, num_cycles=3, num_swapping_pairs=ENS_R // 4,
              global_beta=GLOBAL_BETA, temp_x=TEMP_X,
              threshold_initial=0.999999, threshold_cutoff=0.99999,
              use_coloring=True, lbp_mode="auto", lbp_every=8)
    cfg = ShardedNPTConfig(**{**kw, **(rounds_cfg or {})})
    doNMC = [False] * (ENS_R - ENS_NMC) + [True] * ENS_NMC
    t0 = time.perf_counter()
    ens = EnsembleNMC(probs, beta, doNMC, cfg, device=DEVICE, group=group)
    return probs, ens, time.perf_counter() - t0


def _round_inputs(torch, ens, seed):
    """Random states, ~50% backbones on every slot, the 6 NMC slots and a
    geometric beta_row (global beta on the NMC slots), for one call of a
    round kernel on an engine's layout."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    state = ens.init_state(gen)
    cl = ((torch.rand(state.m.shape, generator=gen, device=DEVICE) < 0.5)
          & ens.active)
    dn = state.do_nmc_slot
    beta = torch.where(dn, GLOBAL_BETA, ens.beta_list[state.slot_to_beta])
    return state.m, cl, dn, beta.contiguous(), gen


def _round_fns(ens):
    """(kernel over the engine's neighbour layout, plain version) of the
    engine's round kernel, both taking (m0, cl, do_nmc, beta_row,
    generator, *, num_cycles, sweeps_per_phase, uniforms, flips)."""
    import functools
    from nmc_tpu_torch.ops import round_cuda as rc
    nbrs = dict(nbrs=ens.round_nbrs)
    if ens.round_path == "K5":
        col_idx, J_tiles = ens._stream_tiles
        pre = (col_idx, J_tiles, ens.h, ens.active)
        return (functools.partial(rc.ensemble_round_sparse, *pre, **nbrs),
                functools.partial(rc.ensemble_round_sparse_reference, *pre))
    pre = (ens.J_full, ens.h, ens.active)
    bs = dict(block_size=ens.blocked0.block_size)
    return (functools.partial(rc.ensemble_round, *pre, **bs, **nbrs),
            functools.partial(rc.ensemble_round_reference, *pre, **bs))


def _c26_16_slots():
    """(EnsembleNMC, launch keywords) of one card's launch in the four-card
    sharded run: chimera 26x26, 16 slots of a 64-slot ladder (geometric
    over beta 0.25-16), replica offset 16."""
    from nmc_tpu_torch.io.generators import chimera_graph
    from nmc_tpu_torch.parallel import EnsembleNMC, ShardedNPTConfig
    R = 16
    ens = EnsembleNMC([chimera_graph(26, 26, seed=0).normalized()[0]],
                      np.geomspace(0.25, 16.0, R), [False] * R,
                      ShardedNPTConfig(use_coloring=True, block_size=128,
                                       num_cycles=3, sweeps_per_phase=64),
                      device=DEVICE)
    return ens, dict(replica_offset=R, replicas_total=4 * R)


@contextlib.contextmanager
def _round_width(rc, threads):
    """The round wrappers' CTA width forced to `threads` inside."""
    own = rc.round_threads
    rc.round_threads = lambda slots, sms: threads
    try:
        yield
    finally:
        rc.round_threads = own


def _tiles_of(torch, ens):
    """K5's union tiles (col_idx, J_tiles) of an engine's dense layout."""
    from types import SimpleNamespace
    from nmc_tpu_torch.parallel.ensemble_nmc import _union_tiles
    b0 = ens.blocked0
    col_idx, J_tiles = _union_tiles([
        SimpleNamespace(J_rows=J, num_blocks=b0.num_blocks,
                        block_size=b0.block_size)
        for J in ens.J_rows.cpu().numpy()])
    return (torch.as_tensor(col_idx, device=DEVICE),
            torch.as_tensor(J_tiles, device=DEVICE))


def _compare_round(torch, name, probs, ens, k, p, m0):
    """Kernel result k against plain result p from identical uniforms: at
    most one replica differing per instance, energies within 1e-3 elsewhere
    and against the f64 energy of the states, padding unmoved."""
    torch.cuda.synchronize()
    differ = (k.m != p.m).any(dim=2) | (k.m_best != p.m_best).any(dim=2)
    per_inst = differ.sum(dim=1)
    check(int(per_inst.max()) <= 1,
          f"{name}: replicas differ per instance {per_inst.tolist()}")
    same = ~differ
    eb_err = float((k.e_best - p.e_best)[same].abs().max())
    ec_err = float((k.e_carried - p.e_carried)[same].abs().max())
    check(eb_err <= 1e-3 and ec_err <= 1e-3,
          f"{name}: e_best off by {eb_err}, e_carried by {ec_err}")
    check(torch.isin(k.m, torch.tensor([-1.0, 1.0], device=DEVICE)).all(),
          f"{name}: spins outside +-1")
    pad = ~ens.active
    check(bool((k.m[..., pad] == m0[..., pad]).all()),
          f"{name}: padding spins moved")
    check(bool((k.m != m0).any()), f"{name}: no spin moved")
    check(bool((k.e_best <= k.e_carried + 1e-4).all()),
          f"{name}: a slot's best is above its carried state")
    inv = ens.blocked0.inv_perm
    m, mb = k.m.cpu().numpy(), k.m_best.cpu().numpy()
    f64 = 0.0
    for i, prob in enumerate(probs):
        f64 = max(f64, float(np.abs(prob.energy(m[i][:, inv])
                                    - k.e_carried[i].cpu().numpy()).max()),
                  float(np.abs(prob.energy(mb[i][:, inv])
                               - k.e_best[i].cpu().numpy()).max()))
    check(f64 <= 1e-3, f"{name}: energies off their f64 value by {f64}")
    return {"replicas_differing": per_inst.tolist(),
            "e_best_max_abs_err": eb_err, "e_carried_max_abs_err": ec_err,
            "vs_f64_max_abs_err": f64}, max(eb_err, ec_err)


def _k4_equals_k5(torch, ens, inputs):
    """K4 over the engine's dense J and K5 over the same layout's union
    tiles, each building its neighbour layout from its own input, with one
    Philox seed: every output and the flip counts equal bit for bit (one
    kernel body over equal layouts)."""
    from nmc_tpu_torch.ops import round_cuda as rc
    m0, cl, dn, beta = inputs
    kw = dict(num_cycles=3, sweeps_per_phase=8)
    col_idx, J_tiles = _tiles_of(torch, ens)
    f4 = torch.zeros(tuple(dn.shape), dtype=torch.int32, device=DEVICE)
    f5 = torch.zeros_like(f4)
    k4 = rc.ensemble_round(
        ens.J_full, ens.h, ens.active, m0, cl, dn, beta,
        torch.Generator(device=DEVICE).manual_seed(7), block_size=128,
        flips=f4, **kw)
    k5 = rc.ensemble_round_sparse(
        col_idx, J_tiles, ens.h, ens.active, m0, cl, dn, beta,
        torch.Generator(device=DEVICE).manual_seed(7), flips=f5, **kw)
    same = all(torch.equal(a, b) for a, b in zip(k4, k5))
    check(same and torch.equal(f4, f5), "K5 differs from K4 with one seed")
    check(bool((k4.m != m0).any()), "K4 moved no spin")
    return same, float(f4.float().mean())


def _occupancy(torch, shapes):
    """ptxas's report for the round kernel's library, and per shape (n_pad,
    the widest step's spins) and CTA width the dynamic shared memory per
    CTA, the registers and the CTAs per SM the CUDA runtime allows for
    them: at least 5 at 256 threads up to n_pad 2048 (one wave of 640 CTAs
    on 132 SMs), else at least 1."""
    from nmc_tpu_torch.ops import _build
    from nmc_tpu_torch.ops import round_cuda as rc
    log = _build.library_path("ensemble_round").with_suffix(".log")
    ptxas = ([ln.strip() for ln in log.read_text().splitlines()
              if "registers" in ln or "spill" in ln] if log.exists() else [])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"ptxas": ptxas, "sm_count": sms}
    for n_pad, step_spins in shapes:
        for width in rc.ROUND_WIDTHS:
            least = 5 if width == rc.ROUND_WIDTHS[0] and n_pad <= 2048 else 1
            regs, ctas = rc.kernel_occupancy(n_pad, step_spins, width)
            out[f"n_pad_{n_pad}_threads_{width}"] = {
                "dynamic_smem_bytes": rc._shared_bytes(n_pad, step_spins),
                "registers": regs, "ctas_per_sm": ctas}
            check(ctas >= least, f"round kernel: {ctas} CTAs per SM at "
                  f"n_pad {n_pad}, {width} threads")
    return out


def _steps(ens, slots):
    """The round layout's steps and row blocks a sweep and the CTA width of
    a launch of `slots` CTAs."""
    from nmc_tpu_torch.ops import round_cuda as rc
    nb = ens.round_nbrs
    return {"steps_per_sweep": nb.step_ptr.numel() - 1,
            "blocks_per_sweep": ens.n_pad // nb.block_size,
            "step_spins": nb.step_spins,
            "cta_width": rc.round_threads(slots, rc._num_sms(ens.device))}


def phase_round_kernels():
    """K4 and K5 against their plain versions and the plain round over
    their neighbour layout at full width with identical uniforms; K4 = K5
    with Philox on +-1 and on Gaussian couplings; the kernel's occupancy;
    the Boltzmann TV of each."""
    import torch
    from nmc_tpu_torch.core.problem import block_sparse_tiles
    from nmc_tpu_torch.ops import round_cuda as rc
    out = {"phase": "round_kernels", "R": ENS_R, "nmc_slots": ENS_NMC,
           "num_cycles": 3, "sweeps_per_phase": 8}
    errs = {}
    kw = dict(num_cycles=3, sweeps_per_phase=8)
    for name, size, count in (("ensemble_round", 8, 4),
                              ("ensemble_round_sparse", 16, 2)):
        probs, ens, _ = _ensemble(size, count)
        want = "K4" if name == "ensemble_round" else "K5"
        check(ens.round_path == want, f"{size}x{size}: {ens.round_path}")
        kernel, plain = _round_fns(ens)
        m0, cl, dn, beta, gen = _round_inputs(torch, ens, 21)
        P = len(rc.phase_list(3, 1))
        u = torch.rand((P, 8) + tuple(m0.shape), generator=gen,
                       device=DEVICE)
        k = kernel(m0, cl, dn, beta, None, uniforms=u, **kw)
        p = plain(m0, cl, dn, beta, None, uniforms=u, **kw)
        res, errs[name] = _compare_round(torch, name, probs, ens, k, p, m0)
        # the plain round over the kernel's own layout and association
        q = rc.ensemble_round_neighbors_reference(
            ens.round_nbrs, ens.h, ens.active, m0, cl, dn, beta, None,
            uniforms=u, **kw)
        res["vs_neighbor_plain"], err = _compare_round(
            torch, f"{name} vs neighbour plain", probs, ens, k, q, m0)
        errs[name] = max(errs[name], err)
        res["vs_neighbor_plain"]["states_bit_equal"] = bool(
            torch.equal(k.m, q.m) and torch.equal(k.m_best, q.m_best))
        res.update(instances=count, n_pad=ens.n_pad,
                   num_blocks=ens.blocked0.num_blocks,
                   layout_entries=int(ens.round_nbrs.src.shape[0]),
                   layout_targets=int(ens.round_nbrs.tgt.shape[0]),
                   **_steps(ens, count * ENS_R))
        check(res["steps_per_sweep"] == 3,
              f"{name}: {res['steps_per_sweep']} steps a sweep, not the 3 "
              "colour classes")
        if want == "K5":
            res["tiles_per_row_block"] = int(ens._stream_tiles[0].shape[1])
        out[name] = res
        if want == "K4":
            k4_ens, k4_inputs = ens, (m0, cl, dn, beta)

    # K4 = K5 with their own Philox draws on the 8x8 family (+-1), then on
    # a Gaussian-coupled 8x8 family, where the two used to sum in
    # different orders
    out["k4_k5_bit_equal_philox"], out["k4_flips_per_slot_mean"] = (
        _k4_equals_k5(torch, k4_ens, k4_inputs))
    _, g_ens, _ = _ensemble(8, 4, pm=False)
    m0, cl, dn, beta, _ = _round_inputs(torch, g_ens, 22)
    out["k4_k5_bit_equal_philox_gaussian"], _ = _k4_equals_k5(
        torch, g_ens, (m0, cl, dn, beta))
    out["occupancy"] = _occupancy(torch, (
        (640, 256), (2048, 768), (5504, 2048)))

    for name in ("ensemble_round", "ensemble_round_sparse"):
        def run(eng, m, gen, beta, sweeps, name=name):
            R, n_pad = m.shape
            zeros = torch.zeros((1, R, n_pad), dtype=torch.bool,
                                device=DEVICE)
            common = (eng.h[None], eng.active, m[None], zeros, zeros[..., 0],
                      torch.full((1, R), beta, device=DEVICE), gen)
            if name == "ensemble_round":
                res = rc.ensemble_round(eng.J_full[None], *common,
                                        block_size=eng.blocked.block_size,
                                        num_cycles=1, sweeps_per_phase=sweeps)
            else:
                ci, jt = block_sparse_tiles(eng.blocked)
                res = rc.ensemble_round_sparse(
                    torch.as_tensor(ci, device=DEVICE),
                    torch.as_tensor(jt, device=DEVICE)[None], *common,
                    num_cycles=1, sweeps_per_phase=sweeps)
            return res.m[0]
        tv = _boltzmann_tv(torch, run)
        check(tv < 0.05, f"{name} Philox TV {tv} >= 0.05")
        out[name]["boltzmann_tv"] = tv
    _icm_round_cases(torch, out, errs)
    emit(out)
    return errs


def _icm_round_cases(torch, out, errs):
    """K4 (2 chimera 8x8 instances) and K5 (2 chimera 16x16) at the ICM
    ensemble's shape, S * R = 10 x 32 = 320 slots per instance, with
    identical injected uniforms against their plain versions and the plain
    round over their neighbour layout, with the rules of the R = 32 cases:
    pure ICM (cl = do_nmc = 0, one cycle, temp_x_inv 1) and hybrid masks
    (3 cycles; do_nmc on half the slots of the 6 coldest rungs, ~30%
    masks there, heated by 1 / temp_x)."""
    from nmc_tpu_torch.ops import round_cuda as rc
    for name, size in (("ensemble_round", 8), ("ensemble_round_sparse", 16)):
        probs, ens, _ = _icm_ensemble(size, 2)
        kernel, plain = _round_fns(ens)
        gen = torch.Generator(device=DEVICE).manual_seed(31)
        state = ens.init_state(gen)
        I, S, R, n = state.m.shape
        Rk = S * R
        m0 = state.m.reshape(I, Rk, n)
        beta = ens.beta_list[state.slot_to_beta].reshape(I, Rk).contiguous()
        res = {"instances": I, "slots": Rk, "n_pad": n}
        for arm in ("icm", "hybrid"):
            if arm == "icm":
                dn = torch.zeros((I, Rk), dtype=torch.bool, device=DEVICE)
                cl = torch.zeros((I, Rk, n), dtype=torch.bool, device=DEVICE)
                kw = dict(num_cycles=1, sweeps_per_phase=8, temp_x_inv=1.0)
            else:
                cold = (state.slot_to_beta >= R - ENS_NMC).reshape(I, Rk)
                dn = cold & (torch.rand((I, Rk), generator=gen,
                                        device=DEVICE) < 0.5)
                cl = ((torch.rand((I, Rk, n), generator=gen, device=DEVICE)
                       < 0.3) & ens.active & dn[..., None])
                kw = dict(num_cycles=3, sweeps_per_phase=8,
                          temp_x_inv=1.0 / TEMP_X)
            P = len(rc.phase_list(kw["num_cycles"], 1))
            u = torch.rand((P, 8, I, Rk, n), generator=gen, device=DEVICE)
            tag = f"{name} {arm} Rk={Rk}"
            k = kernel(m0, cl, dn, beta, None, uniforms=u, **kw)
            p = plain(m0, cl, dn, beta, None, uniforms=u, **kw)
            r, e1 = _compare_round(torch, tag, probs, ens, k, p, m0)
            q = rc.ensemble_round_neighbors_reference(
                ens.round_nbrs, ens.h, ens.active, m0, cl, dn, beta, None,
                uniforms=u, **kw)
            r["vs_neighbor_plain"], e2 = _compare_round(
                torch, f"{tag} vs neighbour plain", probs, ens, k, q, m0)
            r["vs_neighbor_plain"]["states_bit_equal"] = bool(
                torch.equal(k.m, q.m) and torch.equal(k.m_best, q.m_best))
            r["do_nmc_slots"] = int(dn.sum())
            errs[name] = max(errs[name], e1, e2)
            res[arm] = r
        out[f"{name}_icm"] = res


def _ensemble_main_path(size, rounds, chunks, kernel):
    """EnsembleNMC through `kernel` as the campaign drives it: chunks of
    rounds, each ended by best() (the one host sync); the launch counts are
    set to 0 just before and read just after. The last chunk runs with the
    per-stage timing split."""
    import torch
    probs, ens, setup = _ensemble(size, 20)
    want = {"ensemble_round": "K4", "ensemble_round_sparse": "K5"}[kernel]
    check(ens.round_path == want, f"round_path {ens.round_path} != {want}")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    state = ens.init_state(gen)
    per_chunk = rounds // chunks
    chunk_seconds, timings = [], {}
    torch.cuda.synchronize()
    reset_counts()
    for c in range(chunks):
        t0 = time.perf_counter()
        state = ens.run_scanned(
            state, per_chunk, timings=timings if c == chunks - 1 else None)
        eb, mb = ens.best(state)
        chunk_seconds.append(time.perf_counter() - t0)
    ens.flush()
    launches = read_counts()
    check(launches[kernel] == rounds,
          f"{kernel} launched {launches[kernel]} times for {rounds} rounds")
    swap_launches = check_swaps(launches, rounds, f"{kernel} rounds")
    # the round counters: the launch's steps and the block walk's, a sweep
    from nmc_tpu_torch.ops.round_cuda import phase_list
    cfg = ens.cfg
    sweeps = timings["rounds"] * cfg.sweeps_per_phase * len(
        phase_list(cfg.num_cycles, cfg.full_update_frequency))
    steps = _steps(ens, len(probs) * ENS_R)
    counted = {"round_steps_per_sweep": timings["round_steps"] / sweeps,
               "round_blocks_per_sweep": timings["round_blocks"] / sweeps}
    check(counted == {"round_steps_per_sweep": steps["steps_per_sweep"],
                      "round_blocks_per_sweep": steps["blocks_per_sweep"]},
          f"round counters {counted} against the layout's {steps}")
    check(not any(others(launches, kernel, "label_swaps").values()),
          f"other kernels launched: {launches}")
    e64 = np.array([p.energy(mb[i]) for i, p in enumerate(probs)])
    best_err = float(np.abs(e64 - eb).max())
    check(np.isfinite(eb).all() and best_err <= 1e-3,
          f"bests off their f64 energies by {best_err}")
    check(np.isin(mb, [-1.0, 1.0]).all(), "best states outside +-1")
    b2s = state.beta_to_slot.cpu().numpy()
    check(all(sorted(r.tolist()) == list(range(ENS_R)) for r in b2s),
          "beta_to_slot is not a permutation")
    moved = int((state.beta_to_slot
                 != torch.arange(ENS_R, device=DEVICE)).sum())
    cl = state.cl.float().sum(dim=2)[state.do_nmc_slot]
    return launches[kernel], {
        "instances": len(probs), "N": probs[0].n, "n_pad": ens.n_pad,
        "replicas": ENS_R, "nmc_slots": ENS_NMC, "rounds": rounds,
        "chunks": chunks, "round_path": ens.round_path,
        "launches": launches[kernel], "label_swaps_launches": swap_launches,
        "setup_seconds": setup,
        "chunk_seconds": chunk_seconds,
        "seconds_per_round": sum(chunk_seconds) / rounds,
        "last_chunk_split_seconds_per_round": _per_round(timings),
        **counted, "cta_width": steps["cta_width"],
        "best_energy_mean": float(eb.mean()),
        "bests_vs_f64_max_abs_err": best_err,
        "labels_moved": moved,
        "backbone_spins_per_nmc_slot_mean": float(cl.mean()),
    }, (probs, ens, state)


def phase_ensemble_512():
    launches, out, keep = _ensemble_main_path(8, 16, 2, "ensemble_round")
    emit({"phase": "ensemble_512", "reduced": {"rounds": [2777, 16]}, **out})
    return launches, keep


def phase_ensemble_2048():
    launches, out, keep = _ensemble_main_path(16, 8, 1,
                                              "ensemble_round_sparse")
    emit({"phase": "ensemble_2048", "reduced": {"rounds": [2777, 8]}, **out})
    return launches, keep


def phase_round_routing():
    """Not a main path: EnsembleNMC(round_kernel="auto") on a colored
    layout above n_pad 1536 that is not chimera, 4 random 3-regular
    N = 2048 instances (8 PT replicas): it takes K5 over the union tiles
    (a colored layout's diagonal tiles are zero, so some column tile of
    every row block is empty) and runs 2 rounds through it, its launch
    count read, the bests equal to their f64 energies."""
    import torch
    from nmc_tpu_torch.parallel import EnsembleNMC, ShardedNPTConfig
    probs = [_matchings(2048, 3, 100 + s, f"regular3_2048_{s}")
             for s in range(4)]
    cfg = ShardedNPTConfig(use_coloring=True, sweeps_per_phase=16,
                           num_cycles=1, round_kernel="auto")
    ens = EnsembleNMC(probs, np.geomspace(0.3, 3.0, 8), [False] * 8, cfg,
                      device=DEVICE)
    kernel = "ensemble_round_sparse"
    check(ens.round_path == "K5" and ens.n_pad > 1536,
          f"round_path {ens.round_path} at n_pad {ens.n_pad}, not K5")
    state = ens.init_state(torch.Generator(device=DEVICE).manual_seed(1))
    torch.cuda.synchronize()
    reset_counts()
    state = ens.run_scanned(state, 2)
    eb, mb = ens.best(state)
    counts = read_counts()
    check_swaps(counts, 2, "round_routing", main=False)
    check(counts[kernel] == 2
          and not any(others(counts, kernel, "label_swaps").values()),
          f"K5: launches {counts}")
    e64 = np.array([p.energy(mb[i]) for i, p in enumerate(probs)])
    err = float(np.abs(e64 - eb).max())
    check(np.isfinite(eb).all() and err <= 1e-3,
          f"K5: bests off their f64 energies by {err}")
    emit({"phase": "round_routing", "instances": len(probs), "N": 2048,
          "K5": {"n_pad": ens.n_pad, "launches": counts[kernel],
                 "bests_vs_f64_max_abs_err": err}})


def _write_chimera_family(folder, count=3, seed=0):
    """`count` chimera 1x2 instances (16 spins, +-1 couplings, a few
    fields) in the reference's chimera dialect (1-indexed, diagonal lines
    carry h, the file's values negated on load) with groundstates_otn2d.txt
    from enumeration. Returns {name: raw ground-state energy}."""
    import itertools
    import os
    from nmc_tpu_torch.io.generators import chimera_graph
    from nmc_tpu_torch.io.loaders import load_chimera
    rng = np.random.default_rng(seed)
    states = np.array(list(itertools.product([-1.0, 1.0], repeat=16)))
    gs, lines = {}, []
    for k in range(count):
        prob = chimera_graph(1, 2, seed=seed + k)
        h = rng.choice([-0.5, 0.5], size=prob.n) * (rng.random(prob.n) < 0.3)
        name = f"{k + 1:03d}.txt"
        rows = [f"{i + 1} {i + 1} {-h[i]}" for i in range(prob.n) if h[i]]
        iu, ju = np.nonzero(np.triu(prob.J, 1))
        rows += [f"{i + 1} {j + 1} {-prob.J[i, j]}" for i, j in zip(iu, ju)]
        path = os.path.join(folder, name)
        with open(path, "w") as f:
            f.write("\n".join(rows) + "\n")
        e = load_chimera(path).energy(states)
        best = int(np.argmin(e))
        gs[name] = float(e[best])
        bits = " ".join(str(int(x)) for x in (states[best] + 1) // 2)
        lines.append(f"{name} : {gs[name]} {bits}")
    with open(os.path.join(folder, "groundstates_otn2d.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return gs


def phase_campaign():
    """The campaign CLI's nmc arm at its defaults on a small chimera family
    with exact ground states, in process, through K4."""
    import contextlib
    import io
    import os
    import tempfile
    from nmc_tpu_torch import cli
    with tempfile.TemporaryDirectory(prefix="chip_smoke_campaign_") as tmp:
        folder = os.path.join(tmp, "family")
        os.makedirs(folder)
        gs = _write_chimera_family(folder)
        out = os.path.join(tmp, "out.jsonl")
        buf = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(["campaign", "--kind", "chimera", "--folder", folder,
                      "--arm", "nmc", "--out", out, "--device", DEVICE])
        seconds = time.perf_counter() - t0
        launches = read_counts()
        with open(out) as f:
            recs = [json.loads(line) for line in f]
    text = buf.getvalue()
    check("round_path=K4" in text, "the campaign did not take K4")
    check_swaps(launches, launches["ensemble_round"], "campaign")
    check(launches["ensemble_round"] > 0
          and not any(others(launches, "ensemble_round",
                             "label_swaps").values()),
          f"campaign launches {launches}")
    check(sorted(r["name"] for r in recs) == sorted(gs),
          "campaign records do not cover the family")
    check(all(r["hit"] and abs(r["found_raw"] - gs[r["name"]]) <= 1e-9
              for r in recs), "campaign missed a ground state")
    emit({"phase": "campaign", "instances": len(recs), "hits": len(recs),
          "launches": launches["ensemble_round"], "seconds": seconds,
          "hit_sweeps": [r["hit_sweeps"] for r in recs],
          "engine": [ln for ln in text.splitlines()
                     if ln.startswith("engine:")]})
    return launches["ensemble_round"]


# ---- the campaign's ICM arms: EnsembleICM, Houdayer moves, APT + ICM ---------

ICM_S = 10                       # the campaign's --subreplicas


def _icm_ensemble(size, count, hybrid_cold=0, group=None):
    """EnsembleICM on `count` chimera size x size instances (+-1, seeds
    0..), normalized, as the campaign builds its icm / hybrid arms at their
    defaults: the geometric 32-rung ladder over beta 0.25-32, 10
    sub-replicas, 3 x 3 x 64 = 576 sweeps per round, 8 swap pairs,
    houdayer "auto", temp_x 20, 3 cycles (hybrid)."""
    from nmc_tpu_torch.campaign import build_ladder
    from nmc_tpu_torch.io.generators import chimera_graph
    from nmc_tpu_torch.parallel import EnsembleICM, EnsembleICMConfig
    probs = [chimera_graph(size, size, seed=s).normalized()[0]
             for s in range(count)]
    cfg = EnsembleICMConfig(
        sweeps_per_round=576, num_subreplicas=ICM_S,
        num_swapping_pairs=ENS_R // 4, use_coloring=True,
        hybrid_cold=hybrid_cold, temp_x=TEMP_X, num_cycles=3,
        houdayer="auto")
    t0 = time.perf_counter()
    ens = EnsembleICM(probs, build_ladder(0.25, 32.0, ENS_R), cfg,
                      device=DEVICE, group=group)
    return probs, ens, time.perf_counter() - t0


def _icm_kernel_ms(torch, ens, state, iters=2):
    """One pure-ICM round of the ensemble's kernel (3 phases x 192 sweeps
    over all I x 320 slots) on the final state, CUDA events, beside its
    flips per attempt and the least time the card could take for it."""
    from types import SimpleNamespace
    kernel, _ = _round_fns(ens)
    I, S, R, n = state.m.shape
    m0 = state.m.reshape(I, S * R, n)
    beta = ens.beta_list[state.slot_to_beta].reshape(I, S * R).contiguous()
    dn = torch.zeros((I, S * R), dtype=torch.bool, device=DEVICE)
    cl = torch.zeros((I, S * R, n), dtype=torch.bool, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    kw = dict(num_cycles=1, sweeps_per_phase=192, temp_x_inv=1.0)
    flips = torch.zeros((I, S * R), dtype=torch.int32, device=DEVICE)
    kernel(m0, cl, dn, beta, gen, flips=flips, **kw)          # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        kernel(m0, cl, dn, beta, gen, **kw)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    n_flips = int(flips.sum())
    attempts, ops, nbytes = _round_work(
        torch, ens, SimpleNamespace(m=m0, do_nmc_slot=dn, cl=cl), kw,
        n_flips, 576)
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_HBM_BYTES
    return {"kernel_ms_per_round": ms, "attempts": attempts,
            "flips_per_attempt": n_flips / attempts,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "share_of_bound": 1e3 * max(t_ops, t_bytes) / ms}


def _icm_main_path(size, rounds, chunks, kernel, hybrid_cold=0):
    """EnsembleICM through `kernel` on 20 instances as the campaign drives
    it: chunks of rounds, each ended by best(); the launch counts set to 0
    just before and read just after. The last chunk runs with the
    per-stage timing split (round / houdayer / swaps)."""
    import torch
    probs, ens, setup = _icm_ensemble(size, 20, hybrid_cold)
    want = {"ensemble_round": "K4", "ensemble_round_sparse": "K5"}[kernel]
    check(ens.round_path == want, f"round_path {ens.round_path} != {want}")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    state = ens.init_state(gen)
    per_chunk = rounds // chunks
    chunk_seconds, timings, stats = [], {}, {}
    torch.cuda.synchronize()
    reset_counts()
    for c in range(chunks):
        t0 = time.perf_counter()
        state = ens.run_scanned(
            state, per_chunk, timings=timings if c == chunks - 1 else None,
            houdayer_stats=stats)
        eb, mb = ens.best(state)
        chunk_seconds.append(time.perf_counter() - t0)
    ens.flush()
    launches = read_counts()
    check(launches[kernel] == rounds,
          f"{kernel} launched {launches[kernel]} times for {rounds} rounds")
    check(not any(others(launches, kernel, "label_swaps").values()),
          f"other kernels launched: {launches}")
    swap_launches = check_swaps(launches, rounds, f"{kernel} rounds")
    e64 = np.array([p.energy(mb[i]) for i, p in enumerate(probs)])
    best_err = float(np.abs(e64 - eb).max())
    check(np.isfinite(eb).all() and best_err <= 1e-3,
          f"bests off their f64 energies by {best_err}")
    check(np.isin(mb, [-1.0, 1.0]).all(), "best states outside +-1")
    b2s = state.beta_to_slot.cpu().numpy().reshape(-1, ENS_R)
    check(all(sorted(r.tolist()) == list(range(ENS_R)) for r in b2s),
          "a (instance, sub) beta_to_slot is not a permutation")
    moves = state.icm_moves.cpu().numpy()
    flips = state.icm_flips.cpu().numpy()
    check(moves.sum() > 0, "no Houdayer move")
    check(bool((state.m[..., ~ens.active] == 1).all()),
          "padded spins left +1")
    return launches[kernel], {
        "instances": len(probs), "N": probs[0].n, "n_pad": ens.n_pad,
        "replicas": ENS_R, "subreplicas": ICM_S, "slots": ICM_S * ENS_R,
        "rounds": rounds, "chunks": chunks, "round_path": ens.round_path,
        "houdayer": ens.houdayer, "launches": launches[kernel],
        "label_swaps_launches": swap_launches,
        "setup_seconds": setup, "chunk_seconds": chunk_seconds,
        "seconds_per_round": sum(chunk_seconds) / rounds,
        "last_chunk_split_seconds_per_round": _per_round(timings),
        "fixpoint": stats,
        "best_energy_mean": float(eb.mean()),
        "bests_vs_f64_max_abs_err": best_err,
        "icm_moves_per_instance_min": int(moves.min()),
        "icm_moves_total": int(moves.sum()),
        "icm_flips_total": int(flips.sum()),
        "labels_moved": int((state.beta_to_slot != torch.arange(
            ENS_R, device=DEVICE)).sum()),
    }, (probs, ens, state)


def phase_ensemble_icm_512():
    import torch
    launches, out, (probs, ens, state) = _icm_main_path(
        8, 16, 2, "ensemble_round")
    out["kernel_timing"] = _icm_kernel_ms(torch, ens, state)
    emit({"phase": "ensemble_icm_512", "reduced": {"rounds": [2777, 16]},
          **out})
    return launches


def phase_ensemble_icm_2048():
    import torch
    launches, out, keep = _icm_main_path(16, 8, 1, "ensemble_round_sparse")
    out["kernel_timing"] = _icm_kernel_ms(torch, keep[1], keep[2])
    emit({"phase": "ensemble_icm_2048", "reduced": {"rounds": [2777, 8]},
          **out})
    return launches, keep


def phase_hybrid_512():
    """The hybrid arm (hybrid_cold = 6) on 20 chimera 8x8 instances, 8
    rounds through K4: some chains carry heated phases, each mask within
    max_heat_frac of the active spins and empty off those chains."""
    launches, out, (probs, ens, state) = _icm_main_path(
        8, 8, 1, "ensemble_round", hybrid_cold=6)
    dn, cl = state.dn, state.cl
    frac = (cl.sum(dim=-1).float() / ens.active.sum()).cpu().numpy()
    dn_np = dn.cpu().numpy()
    check(dn_np.any(), "no chain carries heated phases")
    check(not cl[~dn].any() and not cl[..., ~ens.active].any(),
          "a mask off its chain or on padded spins")
    check(bool(((frac[dn_np] > 0)
                & (frac[dn_np] <= ens.cfg.max_heat_frac)).all()),
          f"heated masks outside (0, {ens.cfg.max_heat_frac}]")
    emit({"phase": "hybrid_512", "reduced": {"rounds": [2777, 8]}, **out,
          "hybrid_cold": 6, "heated_chains": int(dn_np.sum()),
          "heated_mask_frac_mean": float(frac[dn_np].mean()),
          "heated_mask_frac_max": float(frac[dn_np].max())})
    return launches


def phase_houdayer(keep):
    """The batched Houdayer moves on 3200 real pairs: the ensemble_icm_2048
    run's final states (20 chimera 16x16 instances after 8 rounds of sweeps
    at every rung), sub-replicas (0, 1), ..., (8, 9) paired at each
    temperature. Labels of the sparse, blocked and matmul backends (and
    the dense one on 16 pairs) equal bit for bit, each pair's labels equal
    the component minima of the host components (`disagreement_clusters_
    adj`, scipy); the moves from injected uniforms equal the CPU port's on
    640 of the pairs; ms (CUDA events) and fixed-point iterations per
    backend."""
    import torch
    from nmc_tpu_torch.ops import clusters as oc
    _, ens, state = keep
    I, S, R, n = state.m.shape
    Pn = S // 2
    b2s = state.beta_to_slot
    ii = torch.arange(I, device=DEVICE)[:, None, None]
    sj = torch.arange(0, S, 2, device=DEVICE)[None, :, None].expand(I, Pn, 1)
    slot_j = torch.gather(b2s, 1, sj.expand(I, Pn, R))
    slot_k = torch.gather(b2s, 1, (sj + 1).expand(I, Pn, R))
    s1 = state.m[ii, sj, slot_j].reshape(-1, n).contiguous()
    s2 = state.m[ii, sj + 1, slot_k].reshape(-1, n).contiguous()
    P = s1.shape[0]
    group = torch.arange(I, device=DEVICE).repeat_interleave(Pn * R)
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    g = torch.rand((P, n), generator=gen, device=DEVICE)
    # the engine's own operands: the matmul index table (its "auto"
    # backend at chimera 16x16) and K5's union tiles; edge lists from J
    check(ens.houdayer == "matmul" and ens.round_path == "K5",
          f"houdayer {ens.houdayer}, round_path {ens.round_path}")
    planes = ens._houd
    col_u, tiles = ens._stream_tiles
    adj_t = tiles != 0
    J_full = ens.J_full
    J_np = J_full.cpu().numpy()
    srcs, dsts, adjs = [], [], []
    for i in range(I):
        iu, ju = np.nonzero(np.triu(J_np[i], 1))
        srcs.append(np.concatenate([iu, ju]))
        dsts.append(np.concatenate([ju, iu]))
        adjs.append(oc.CSRAdjacency(J_np[i]))
    E = max(x.size for x in srcs)

    def pad(x):
        return np.concatenate([x, np.full(E - x.size, n - 1)])

    src = torch.as_tensor(np.stack([pad(x) for x in srcs]), device=DEVICE)
    dst = torch.as_tensor(np.stack([pad(x) for x in dsts]), device=DEVICE)
    backends = {
        "sparse": lambda a, b, grp, st: oc.houdayer_move_sparse(
            src, dst, a, b, g=g[:a.shape[0]], group=grp, stats=st),
        "blocked": lambda a, b, grp, st: oc.houdayer_move_blocked(
            col_u, adj_t, a, b, g=g[:a.shape[0]], group=grp, stats=st),
        "matmul": lambda a, b, grp, st: oc.houdayer_move_matmul(
            planes, a, b, g=g[:a.shape[0]], group=grp, stats=st),
        "device": lambda a, b, grp, st: oc.houdayer_move_device(
            J_full, a, b, g=g[:a.shape[0]], group=grp, stats=st)}
    out = {"phase": "houdayer", "pairs": P, "n_pad": n, "instances": I,
           "disagreeing_spins_per_pair_mean": float(
               (s1 != s2).float().sum(1).mean())}
    labels, moves = {}, {}
    for name, fn in backends.items():
        a, b, grp = ((s1, s2, group) if name != "device"
                     else (s1[:16], s2[:16], group[:16]))
        lab_fn = {"sparse": lambda: oc.disagreement_labels_sparse(
                      src, dst, a, b, group=grp),
                  "blocked": lambda: oc.disagreement_labels_blocked(
                      col_u, adj_t, a, b, group=grp),
                  "matmul": lambda: oc.disagreement_labels_matmul(
                      planes, a, b, group=grp),
                  "device": lambda: oc.disagreement_labels_device(
                      J_full, a, b, group=grp)}[name]
        labels[name] = lab_fn()
        st = {}
        fn(a, b, grp, st)                                     # warm-up
        times = []
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            moves[name] = fn(a, b, grp, None)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        out[name] = {"pairs": a.shape[0], "ms": times,
                     "ms_per_call": min(times), **st}
    for name in ("blocked", "matmul"):
        check(torch.equal(labels[name], labels["sparse"]),
              f"houdayer: {name} labels differ from sparse")
        check(all(torch.equal(x, y) for x, y in zip(moves[name],
                                                    moves["sparse"])),
              f"houdayer: {name} moves differ from sparse")
    check(torch.equal(labels["device"], labels["sparse"][:16]),
          "houdayer: dense labels differ from sparse")
    # host components, pair by pair
    lab = labels["sparse"].cpu().numpy()
    a_np, b_np = s1.cpu().numpy(), s2.cpu().numpy()
    grp_np = group.cpu().numpy()
    t0 = time.perf_counter()
    for p in range(P):
        want = np.full(n, n)
        for c in oc.disagreement_clusters_adj(adjs[grp_np[p]], a_np[p],
                                              b_np[p]):
            want[c] = c.min()
        check(np.array_equal(lab[p], want),
              f"houdayer: pair {p} labels off the host components")
    out["host_components_seconds"] = time.perf_counter() - t0
    # the CPU port on 640 pairs (4 instances), the same injected uniforms
    sub = slice(0, min(4 * Pn * R, P))
    cpu = oc.houdayer_move_sparse(
        src.cpu(), dst.cpu(), s1[sub].cpu(), s2[sub].cpu(),
        g=g[sub].cpu(), group=group[sub].cpu())
    check(all(torch.equal(x[sub].cpu(), y)
              for x, y in zip(moves["matmul"], cpu)),
          "houdayer: the card's moves differ from the CPU port's")
    out["moved"] = int(moves["matmul"][2].sum())
    out["flipped"] = int(moves["matmul"][3].sum())
    out["cpu_pairs_compared"] = sub.stop
    emit(out)


def phase_campaign_icm():
    """The campaign CLI's icm, hybrid and icm_host arms at their defaults
    on the small chimera family with exact ground states, in process: every
    instance a hit; icm and hybrid through K4, icm_host through K1."""
    import contextlib
    import io
    import os
    import tempfile
    from nmc_tpu_torch import cli
    out = {"phase": "campaign_icm"}
    launches = {"ensemble_round": 0, "colored_sweeps": 0}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_icm_") as tmp:
        folder = os.path.join(tmp, "family")
        os.makedirs(folder)
        gs = _write_chimera_family(folder)
        for arm in ("icm", "hybrid", "icm_host"):
            kernel = "colored_sweeps" if arm == "icm_host" else \
                "ensemble_round"
            path = os.path.join(tmp, f"{arm}.jsonl")
            buf = io.StringIO()
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cli.main(["campaign", "--kind", "chimera", "--folder", folder,
                          "--arm", arm, "--out", path, "--device", DEVICE])
            seconds = time.perf_counter() - t0
            counts = read_counts()
            with open(path) as f:
                recs = [json.loads(line) for line in f]
            text = buf.getvalue()
            check(arm == "icm_host" or "round_path=K4" in text,
                  f"campaign {arm} did not take K4")
            check_swaps(counts, 0 if arm == "icm_host" else counts[kernel],
                        f"campaign {arm}")
            check(counts[kernel] > 0
                  and not any(others(counts, kernel, "label_swaps").values()),
                  f"campaign {arm} launches {counts}")
            check(sorted(r["name"] for r in recs) == sorted(gs),
                  f"campaign {arm}: records do not cover the family")
            check(all(r["hit"] and abs(r["found_raw"] - gs[r["name"]])
                      <= 1e-9 for r in recs),
                  f"campaign {arm} missed a ground state")
            launches[kernel] += counts[kernel]
            out[arm] = {"instances": len(recs), "hits": len(recs),
                        "launches": counts[kernel], "kernel": kernel,
                        "seconds": seconds,
                        "hit_sweeps": [r["hit_sweeps"] for r in recs],
                        "engine": [ln for ln in text.splitlines()
                                   if ln.startswith("engine:")]}
    emit(out)
    return launches


def phase_apt_icm(c2048):
    """The icm CLI at its defaults (8 replicas x 10 sub-replicas, 10000
    sweeps, 100 swap rounds, --coloring): chimera 8x8 with host ICM through
    K1, chimera 16x16 with --device-icm through K3. Two sweep launches a
    round; the last round's f32 best against the f64 energy of the best
    state; Houdayer moves made."""
    import contextlib
    import io
    import os
    import tempfile
    from nmc_tpu_torch import cli
    out = {"phase": "apt_icm"}
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_apt_icm_") as tmp:
        for tag, prob, extra, kernel in (
                ("chimera512", _flagship()[0], [], "colored_sweeps"),
                ("chimera2048", c2048[0], ["--device-icm"],
                 "colored_sweeps_sparse")):
            J = os.path.join(tmp, f"{tag}.npy")
            np.save(J, prob.J)
            metrics = os.path.join(tmp, f"{tag}.jsonl")
            buf = io.StringIO()
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cli.main(["icm", "--J", J, "--coloring", "--device", DEVICE,
                          "--metrics", metrics, *extra])
            seconds = time.perf_counter() - t0
            counts = read_counts()
            rec = json.loads(buf.getvalue().strip().splitlines()[-1])
            with open(metrics) as f:
                rounds = [r for r in map(json.loads, f)
                          if r.get("phase") == "icm_round"]
            check(counts[kernel] == 200
                  and all(v == 0 for k, v in counts.items() if k != kernel),
                  f"icm {tag}: launches {counts}")
            err = abs(rounds[-1]["min_energy"] - rec["min_energy"])
            check(len(rounds) == 100 and err <= 1e-3,
                  f"icm {tag}: best off its f64 energy by {err}")
            check(rec["icm_moves"] > 0, f"icm {tag}: no Houdayer move")
            launches[kernel] = counts[kernel]
            out[tag] = {"N": prob.n, "kernel": kernel,
                        "launches": counts[kernel], "seconds": seconds,
                        "seconds_per_round": seconds / 100,
                        "device_icm": bool(extra),
                        "min_energy": rec["min_energy"],
                        "best_f32_vs_f64_abs_err": err,
                        "icm_moves": rec["icm_moves"],
                        "icm_flips": rec["icm_flips"]}
    emit(out)
    return launches


def _round_work(torch, ens, state, cfg_kw, flips, sweeps_per_round):
    """(operations, bytes) of one round on these inputs: per attempted spin
    update (the phase masks of the NMC slots counted) 110 operations, per
    flip one FMA per nonzero coupling of the row, per sweep 3 per spin for
    the energy, per phase and at the end a phi rebuild over the nonzero
    couplings; each input (the couplings as the kernel's neighbour layout)
    read once and each output written once."""
    from nmc_tpu_torch.ops.round_cuda import phase_list
    act = ens.active
    dn = state.do_nmc_slot[..., None]
    cl = state.cl
    T = cfg_kw["sweeps_per_phase"]
    attempts = 0
    for kind in phase_list(cfg_kw["num_cycles"], 1):
        if kind == "C":
            mask = torch.where(dn, cl & act, act)
        elif kind == "NC":
            mask = torch.where(dn, ~cl & act, act)
        else:
            mask = act.expand_as(cl)
        attempts += T * int(mask.sum())
    I, R, n_pad = state.m.shape
    nnz = int((ens.J_full != 0).sum())              # over all instances
    degree = nnz / (I * int(act.sum()))
    P = len(phase_list(cfg_kw["num_cycles"], 1))
    ops = (attempts * OPS_PER_ATTEMPT + flips * 2 * degree
           + 3 * I * R * n_pad * sweeps_per_round + 2 * R * nnz * (P + 1))
    j_bytes = sum(t.numel() * t.element_size() for t in ens.round_nbrs
                  if isinstance(t, torch.Tensor))
    nbytes = (j_bytes + 4 * I * n_pad + n_pad              # J, h, act
              + 4 * I * R * n_pad + I * R * n_pad          # m0, cl
              + I * R + 4 * I * R + 8                      # do_nmc, beta, seed
              + 2 * 4 * I * R * n_pad + 2 * 4 * I * R)     # outputs
    return attempts, ops, nbytes


def _throughput_round(torch, name, keep, iters=3, plain_sweeps=8):
    """A round kernel and its plain version in turns (plain, kernel, kernel,
    plain) on an ensemble run's final state; the plain version runs
    `plain_sweeps` sweeps per phase and its time is scaled to 64."""
    probs, ens, state = keep
    kernel, plain = _round_fns(ens)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    beta = torch.where(state.do_nmc_slot, GLOBAL_BETA,
                       ens.beta_list[state.slot_to_beta]).contiguous()
    args = (state.m, state.cl, state.do_nmc_slot, beta, gen)
    full = dict(num_cycles=3, sweeps_per_phase=64)
    cut = dict(num_cycles=3, sweeps_per_phase=plain_sweeps)
    flips = torch.zeros(tuple(beta.shape), dtype=torch.int32, device=DEVICE)
    kernel(*args, flips=flips, **full)                   # warm-up
    times = {"kernel": [], "plain_scaled": []}
    for turn in ("plain", "kernel", "kernel", "plain"):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        n = iters if turn == "kernel" else 1
        start.record()
        for _ in range(n):
            if turn == "kernel":
                kernel(*args, **full)
            else:
                plain(*args, **cut)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / n
        if turn == "kernel":
            times["kernel"].append(ms)
        else:
            times["plain_scaled"].append(ms * 64 / plain_sweeps)
    sweeps_per_round = 3 * 3 * 64
    n_flips = int(flips.sum())
    probes = _round_probes(torch, ens, kernel, args)
    attempts, ops, nbytes = _round_work(torch, ens, state, full, n_flips,
                                        sweeps_per_round)
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_HBM_BYTES
    k_ms, p_ms = min(times["kernel"]), min(times["plain_scaled"])
    I, R, n_pad = state.m.shape
    return {"name": name, "instances": I, "R": R, "N": probs[0].n,
            "n_pad": n_pad, "sweeps_per_launch": sweeps_per_round,
            "iters": iters, "ms": times, "kernel_ms_per_call": k_ms,
            "plain_ms_per_call": p_ms,
            "plain_note": f"plain version timed at {plain_sweeps} sweeps "
                          "per phase, scaled to 64",
            "attempts_per_launch": attempts,
            "kernel_attempts_per_s": attempts / (k_ms * 1e-3),
            "flips_per_attempt": n_flips / attempts,
            "bound_ops": ops, "bound_bytes": nbytes,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "share_of_bound": 1e3 * max(t_ops, t_bytes) / k_ms,
            "probes": probes}


def _round_probes(torch, ens, kernel, args):
    """Single launches that split a round kernel's time: the same launch
    (`base`); 8 instead of 64 sweeps per phase (the phi rebuilds and fixed
    costs stay: t = a + b * sweeps); every slot at the coldest rung, 32
    (few flips); and the first instance's couplings for all 640 slots
    (one instance's layout weights instead of 20 in the caches). ms and
    flips per attempt of each."""
    m, cl, dn, beta, gen = args
    I, R, n_pad = m.shape

    def once(fn, *a, sweeps=64):
        flips = torch.zeros(tuple(a[3].shape), dtype=torch.int32,
                            device=DEVICE)
        fn(*a, flips=flips, num_cycles=3, sweeps_per_phase=sweeps)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*a, num_cycles=3, sweeps_per_phase=sweeps)
        end.record()
        torch.cuda.synchronize()
        return {"ms": start.elapsed_time(end),
                "flips_per_slot_sweep": float(flips.float().mean())
                / (9 * sweeps)}

    out = {"base": once(kernel, *args),
           "sweeps_per_phase_8": once(kernel, *args, sweeps=8),
           "cold_beta_32": once(kernel, m, cl, dn, torch.full_like(beta, 32.0),
                                gen)}
    out["base_over_cold"] = out["base"]["ms"] / out["cold_beta_32"]["ms"]
    from nmc_tpu_torch.ops import round_cuda as rc
    nbrs = ens.round_nbrs._replace(w=ens.round_nbrs.w[:1].contiguous())
    h1 = ens.h[:1].contiguous()
    if ens.round_path == "K4":
        fn = functools.partial(rc.ensemble_round, ens.J_full[:1].contiguous(),
                               h1, ens.active,
                               block_size=ens.blocked0.block_size, nbrs=nbrs)
    else:
        col_idx, J_tiles = ens._stream_tiles
        fn = functools.partial(rc.ensemble_round_sparse, col_idx,
                               J_tiles[:1].contiguous(), h1, ens.active,
                               nbrs=nbrs)
    flat = (m.reshape(1, I * R, n_pad), cl.reshape(1, I * R, n_pad),
            dn.reshape(1, I * R), beta.reshape(1, I * R), gen)
    out["one_instance_640_slots"] = once(fn, *flat)
    return out


# ---- the exact solver: table kernels K6 / K7 ---------------------------------

def _planted_signs(n, seed):
    """A random +-1 state with t_0 = +1 (the solvers pin s_0 = +1), so
    that the planted ground state is not table entry (0, 0)."""
    t = np.random.default_rng(seed).choice([-1.0, 1.0], n)
    t[0] = 1.0
    return t


def _planted_integer(n, seed):
    """An integer planted wishart (test data): W [n, n/2] with entries in
    [-3, 3] and every column summing to 0, its rows multiplied by a random
    t, J = -W W^T with a zero diagonal. Then E(m) = 1/2 (|W^T m|^2 -
    sum_i |W_i|^2) and W^T t = 0, so t is a ground state with E(t) = -1/2
    sum_i |W_i|^2. Returns (J, t, E(t))."""
    rng = np.random.default_rng(seed)
    W = rng.integers(-3, 4, (n, n // 2))
    for c in range(W.shape[1]):
        while (total := int(W[:, c].sum())) != 0:
            step = -1 if total > 0 else 1
            movable = np.nonzero(np.abs(W[:, c] + step) <= 3)[0]
            W[rng.choice(movable), c] += step
    t = _planted_signs(n, seed + 1000)
    W = W * t[:, None].astype(np.int64)
    J = -(W @ W.T).astype(np.float64)
    np.fill_diagonal(J, 0.0)
    return J, t, -0.5 * float((W.astype(np.float64) ** 2).sum())


@functools.lru_cache(maxsize=None)
def _exact40():
    """The two N = 40 planted wisharts of the exact phases: "float"
    (`wishart_planted(40, 0.5, seed=0)` planted at a random t, -> K6) and
    "int" (`_planted_integer`, -> K7), each (J, t, E(t))."""
    from nmc_tpu_torch.io.generators import wishart_planted
    prob, t, e = wishart_planted(40, 0.5, seed=0,
                                 planted=_planted_signs(40, 2000))
    return {"float": (prob.J, t, e), "int": _planted_integer(40, 0)}


def _exact_args(torch, J, planes, block_a=512, block_b=4096):
    """The fused tier's kernel inputs for J (h = 0) on the card: (K7?,
    (SA, C, EA, EB), layout (a, b, symmetry, block_a, block_b) with the
    blocks clamped)."""
    from nmc_tpu_torch.core.problem import IsingProblem
    from nmc_tpu_torch.exact import fused_inputs
    n = J.shape[0]
    use_i8, arrays, layout = fused_inputs(
        IsingProblem(J, np.zeros(n)), block_a=block_a, block_b=block_b,
        planes=planes)
    args = tuple(torch.as_tensor(x, device=DEVICE) for x in arrays)
    return use_i8, args, layout


def _exact_fns(use_i8):
    from nmc_tpu_torch.ops import exact_cuda as ec
    if use_i8:
        return "mitm_min_i8", ec.mitm_min_i8, ec.mitm_min_i8_reference
    return "mitm_min", ec.mitm_min, ec.mitm_min_reference


def phase_exact_kernels():
    """K6 and K7 against their plain versions at N = 32 on integer-coupled
    instances, min and argmin element for element, pad rows included; K6 =
    K7 on the rows both reduce; K7 with 3 digit planes past K6's window."""
    import torch
    from nmc_tpu_torch.exact import exact_energy_bound
    n = 32
    rng = np.random.default_rng(7)
    ties = np.triu(rng.choice([-1.0, 0.0, 1.0], size=(n, n)), 1)
    big = np.triu(rng.integers(-80_000, 80_001, (n, n)).astype(np.float64), 1)
    Js = {"planted_int": _planted_integer(n, 1)[0], "ties": ties + ties.T,
          "three_planes": big + big.T}
    bound = exact_energy_bound(Js["three_planes"])
    check(float(1 << 24) < bound < float(1 << 29),
          f"three_planes bound {bound} outside (2^24, 2^29)")
    out = {"phase": "exact_kernels", "N": n, "a": n // 2}
    errs = {"mitm_min": 0.0, "mitm_min_i8": 0.0}
    kept = {}
    for name, planes, block_a in (("planted_int", "on", 512),
                                  ("planted_int", "off", 512),
                                  ("ties", "on", 384), ("ties", "off", 384),
                                  ("three_planes", "on", 512)):
        use_i8, args, (a, _, _, *blocks) = _exact_args(torch, Js[name],
                                                       planes, block_a)
        total_a = 1 << (a - 1)
        kname, kernel, plain = _exact_fns(use_i8)
        check(use_i8 == (planes == "on"), f"{name}: planes={planes} took "
              f"{kname}")
        k = kernel(*args, block_a=blocks[0], block_b=blocks[1])
        p = plain(*args, block_a=blocks[0], block_b=blocks[1])
        torch.cuda.synchronize()
        n_e = int((k[0] != p[0]).sum())
        n_b = int((k[1] != p[1]).sum())
        check(n_e == 0 and n_b == 0, f"{kname} on {name}: {n_e} minima and "
              f"{n_b} argmins differ from the plain version")
        live = torch.isfinite(p[0].float()) if not use_i8 else slice(None)
        errs[kname] = max(errs[kname], float(
            (k[0][live].double() - p[0][live].double()).abs().max()))
        SA, C, EA, EB = args
        TA, TB = SA.shape[0], EB.shape[0]
        res = {"kernel": kname, "TA": TA, "TB": TB, "block_a": blocks[0],
               "pad_rows": TA - total_a, "min_and_argmin_equal": True}
        if use_i8:
            res["digit_planes"] = C.shape[0]
        else:
            # rows of the first 1024 whose minimum several columns attain:
            # the lowest-index tie-break decides them
            T = EA[:1024, None] + EB[None, :] - SA[:1024] @ C
            res["tied_rows_of_1024"] = int(
                ((T == T.min(dim=1, keepdim=True).values).sum(dim=1) > 1)
                .sum())
        out[f"{name}_{planes}"] = res
        kept[(name, planes)] = (k[0][:total_a].cpu().numpy(),
                                k[1][:total_a].cpu().numpy())
    check(out["ties_off"]["tied_rows_of_1024"] > 0, "no tied rows")
    check(out["ties_on"]["pad_rows"] > 0, "block_a = 384 did not pad TA")
    check(out["three_planes_on"]["digit_planes"] == 3,
          f"{out['three_planes_on']['digit_planes']} digit planes, not 3")
    for name in ("planted_int", "ties"):
        (e7, b7), (e6, b6) = kept[(name, "on")], kept[(name, "off")]
        check(np.array_equal(e7.astype(np.float64), e6.astype(np.float64))
              and np.array_equal(b7, b6), f"K6 != K7 on {name}")
        out[f"{name}_k6_equals_k7"] = True
    try:
        _exact_args(torch, Js["three_planes"], "off")
        raise AssertionError("planes='off' accepted a bound above 2^24")
    except ValueError as e:
        check("2^24" in str(e), f"unexpected refusal: {e}")
    out["three_planes_off_refused"] = True
    emit(out)
    return errs


def _write_wishart(path, J):
    """J in the reference's wishart dialect: 0-indexed `i j w` lines, w the
    negated coupling (the loader negates), by repr so it loads back
    exactly."""
    iu, ju = np.nonzero(np.triu(J, 1))
    with open(path, "w") as f:
        f.write("".join(f"{i} {j} {float(-J[i, j])!r}\n"
                        for i, j in zip(iu, ju)))


def _write_wishart_folder(folder, n, insts):
    """Planted instances {key: (J, t, E(t))} as one wishart folder of size
    n with its gs_energies.txt; returns {key: path}."""
    import os
    from nmc_tpu_torch.io.loaders import load_wishart
    os.makedirs(folder)
    paths, lines = {}, []
    for i, (key, (J, t, e)) in enumerate(insts.items()):
        name = f"wishart_planting_N_{n}_alpha_0.50_inst_{i + 1}.txt"
        paths[key] = os.path.join(folder, name)
        _write_wishart(paths[key], J)
        prob = load_wishart(paths[key])
        check(np.array_equal(prob.J, J), f"{key} does not load back")
        check(float(prob.energy(t)) == e, f"{key}: planted energy")
        lines.append(f"{name}\t{e!r}\n")
    with open(os.path.join(folder, "gs_energies.txt"), "w") as f:
        f.write("".join(lines))
    return paths


def _exact_cli(tmp, path, backend, planes="auto", blocks=None):
    """One `exact` command in process, the launch counts set to 0 just
    before it; the fused tier records its split (`timings`). Returns (JSON
    record, saved state, seconds of the command, launches, split)."""
    import contextlib
    import io
    import os
    import torch
    from nmc_tpu_torch import cli
    from nmc_tpu_torch import exact as exact_mod
    state = os.path.join(tmp, "state.txt")
    argv = ["exact", path, "--backend", backend, "--planes", planes, "--out",
            os.path.join(tmp, "out.jsonl"), "--save-state", state,
            "--device", DEVICE]
    if blocks:
        argv += ["--block-a", str(blocks[0]), "--block-b", str(blocks[1])]
    buf, split = io.StringIO(), {}
    solve = exact_mod.solve_exact_fused
    exact_mod.solve_exact_fused = functools.partial(solve, timings=split)
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        seconds = time.perf_counter() - t0
        counts = read_counts()
    finally:
        exact_mod.solve_exact_fused = solve
    check(rc == 0, f"exact {argv}: exit {rc}")
    rec = json.loads(buf.getvalue().splitlines()[-1])
    return rec, np.loadtxt(state), seconds, counts, split


def phase_exact_40():
    """The `exact` command at N = 40 on two planted wisharts, in process:
    float couplings through K6, integer couplings through K7 and, with
    --planes off, through K6; then the torch-tile tier on the integer one.
    Each run must return its planted state t (t_0 = +1, t random) and
    E(t); the fused runs print their split: host tables, upload, kernel
    (launch to results on the host), verification."""
    import os
    import tempfile
    n = 40
    insts = _exact40()
    launches = {"mitm_min": 0, "mitm_min_i8": 0}
    out = {"phase": "exact_40", "N": n, "table_entries": 2 ** (n - 1)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_exact_") as tmp:
        paths = _write_wishart_folder(
            os.path.join(tmp, "wishart_planting_N_40_alpha_0.50"), n, insts)
        for key, backend, planes, kernel in (
                ("float", "pallas", "auto", "mitm_min"),
                ("int", "pallas", "auto", "mitm_min_i8"),
                ("int", "pallas", "off", "mitm_min"),
                ("int", "device", "auto", None)):
            rec, s, seconds, counts, split = _exact_cli(
                tmp, paths[key], backend, planes,
                (8192, 65536) if backend == "device" else None)
            _, t, e = insts[key]
            tag = f"{key} {backend} planes={planes}"
            check(rec["matches_shipped"] is True and rec["energy_raw"] == e,
                  f"{tag}: {rec} against {e}")
            check(np.array_equal(s, t), f"{tag}: not the planted state")
            others = {k: v for k, v in counts.items() if k != kernel}
            check((kernel is None or counts[kernel] >= 1)
                  and not any(others.values()), f"{tag}: launches {counts}")
            if kernel:
                launches[kernel] += counts[kernel]
            out[f"{key}_{backend}_{planes}"] = {
                "kernel": kernel, "launches": counts.get(kernel, 0),
                "energy_raw": rec["energy_raw"],
                "matches_shipped": rec["matches_shipped"],
                "planted_state": True, "wall_seconds": rec["wall_seconds"],
                "seconds": seconds, "split_seconds": split or None}
    check(out["int_pallas_auto"]["energy_raw"]
          == out["int_pallas_off"]["energy_raw"], "K6 and K7 energies differ")
    out["launches"] = launches
    emit(out)
    return launches, out["float_pallas_auto"]["energy_raw"]


def phase_exact_tiers():
    """Not a main path: the `exact` command through each tier on integer
    planted wisharts at N = 28-40, the crossover `--backend auto` follows:
    host (N = 28 only), the torch tiles at the command's default blocks
    (512 x 4096, what `auto` ran there before) and at 8192 x 65536, the
    fused kernels, and `auto` itself (which must take the fused tier from
    N = 29). Every run must return the planted state."""
    import os
    import tempfile
    out = {"phase": "exact_tiers", "wall_seconds": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tiers_") as tmp:
        for n in (28, 30, 34, 38, 40):
            inst = (_exact40()["int"] if n == 40
                    else _planted_integer(n, 10 + n))
            path = _write_wishart_folder(
                os.path.join(tmp, f"wishart_planting_N_{n}_alpha_0.50"), n,
                {"int": inst})["int"]
            runs = {"device_512x4096": ("device", None),
                    "device_8192x65536": ("device", (8192, 65536)),
                    "pallas": ("pallas", None), "auto": ("auto", None)}
            if n == 28:
                runs["host"] = ("host", None)
            walls = {}
            for label, (backend, blocks) in runs.items():
                rec, s, seconds, counts, _ = _exact_cli(tmp, path, backend,
                                                        blocks=blocks)
                check(rec["matches_shipped"] is True
                      and np.array_equal(s, inst[1]),
                      f"N = {n} {label}: {rec}")
                walls[label] = {"wall_seconds": rec["wall_seconds"],
                                "seconds_with_load": seconds}
                if label == "auto":
                    want = "host" if n <= 28 else "pallas"
                    check(rec["backend"] == want and (
                        n <= 28 or counts["mitm_min_i8"] == 1),
                        f"N = {n}: auto took {rec['backend']}, {counts}")
            out["wall_seconds"][n] = walls
    emit(out)


# ---- the solve portfolio: spectral search, solve, refine, enumeration --------

# the keys of a `solve` record and of each of its stages, as the JAX
# package's `solve` command prints them (nmc_tpu/cli.py cmd_solve)
SOLVE_KEYS = {"name", "n", "kind", "energy_raw", "target_raw", "hit",
              "wall_seconds", "stages"}
STAGE_KEYS = {"stage", "energy_raw", "wall_seconds", "hit"}
STAGE_DETAIL = {"presolve": {"n", "core_n", "constant"},
                "spectral": {"dm_starts"},
                "mcmc:icm": {"hit_sweeps", "rounds"},
                "tree": {"moves", "ils_iters"}}
REFINE_KEYS = {"name", "kind", "energy_raw", "target_raw", "e_int_start",
               "e_int", "q", "target_int", "hit", "moves", "ils_iters",
               "seconds"}


def _min_one_flip_dE(J, S):
    """The least single-flip energy change over the rows of S, in f64:
    >= 0 (up to the f32 descent's 1e-6 stop) when every row is 1-flip
    stable."""
    S = np.asarray(S, np.float64)
    return float((2.0 * S * (S @ np.asarray(J, np.float64))).min())


def _write_chimera(path, prob):
    """`prob` in the reference's chimera dialect (1-indexed, diagonal lines
    carry h, the file's values negated on load), by repr so it loads back
    exactly."""
    rows = [f"{i + 1} {i + 1} {float(-prob.h[i])!r}" for i in range(prob.n)
            if prob.h[i]]
    iu, ju = np.nonzero(np.triu(prob.J, 1))
    rows += [f"{i + 1} {j + 1} {float(-prob.J[i, j])!r}"
             for i, j in zip(iu, ju)]
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def _cli(argv):
    """One command of the port's CLI in process, the launch counts set to 0
    just before it and read just after. Returns (exit code, the last JSON
    line, seconds, launches, stdout)."""
    import contextlib
    import io
    import torch
    from nmc_tpu_torch import cli
    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    text = buf.getvalue()
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    return rc, (json.loads(lines[-1]) if lines else None), seconds, counts, \
        text


def _stage_seconds(rec):
    return {s["stage"]: s["wall_seconds"] for s in rec["stages"]}


def _check_solve_record(tag, rec, stages):
    check(set(rec) == SOLVE_KEYS, f"{tag}: record keys {sorted(rec)}")
    check([s["stage"] for s in rec["stages"]] == stages,
          f"{tag}: stages {[s['stage'] for s in rec['stages']]}")
    for st in rec["stages"]:
        check(set(st) == STAGE_KEYS | STAGE_DETAIL[st["stage"]],
              f"{tag}: stage keys {sorted(st)}")


def phase_spectral():
    """The host spectral search at the portfolio's defaults on a planted
    wishart N = 40 against the torch device search on the card (the
    difference-map pool at its full width, the device default d = n/2):
    both reach the planted energy, every device candidate 1-flip stable in
    f64. Then the device candidates without the pool on chimera 16x16 (the
    MCMC stage's seeding problem of `solve_chimera2048`), timed."""
    import torch
    from nmc_tpu_torch.io.generators import chimera_graph, wishart_planted
    from nmc_tpu_torch.ops import spectral as sp
    prob, t, e = wishart_planted(40, 0.5, seed=0)
    t0 = time.perf_counter()
    r = sp.spectral_search(prob, dm_starts=2048, dm_iters=3000, dm_dim=None,
                           polish=8, seed=0)
    host = time.perf_counter() - t0
    check(abs(r.best_energy - e) <= 1e-9,
          f"host spectral search {r.best_energy} misses the planted {e}")
    out = {"phase": "spectral", "N": 40, "planted_energy": e,
           "host_seconds": host, "host_best": r.best_energy,
           "host_candidates": int(r.states.shape[0])}
    reset_counts()
    dev = []
    for seed in (0, 1):      # the first call also sets up cuSOLVER / cuBLAS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S, E = sp.spectral_candidates_device(
            prob.J, dm_starts=2048, dm_iters=3000, device=DEVICE,
            generator=torch.Generator(device=DEVICE).manual_seed(seed))
        S64 = S.double().cpu().numpy()
        dev.append(time.perf_counter() - t0)
        dE = _min_one_flip_dE(prob.J, S64)
        check(dE >= -1e-5, f"device candidate not 1-flip stable: dE {dE}")
        e_best = float(prob.energy(S64[0]))
        check(abs(e_best - r.best_energy) <= 1e-9,
              f"device best {e_best} != host best {r.best_energy}")
        check(abs(float(E[0]) - e_best) <= 1e-5 * abs(e_best),
              f"device energy {float(E[0])} against f64 {e_best}")
    check(not any(read_counts().values()), "the spectral search launched "
          "a kernel")
    out.update(device_seconds=dev, device_candidates=int(S.shape[0]),
               device_best_f64=e_best, min_one_flip_dE_f64=dE,
               host_over_device=host / dev[1])
    c = chimera_graph(16, 16, seed=0).normalized()[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Sc, Ec = sp.spectral_candidates_device(c.J, device=DEVICE)
    Sc64 = Sc.double().cpu().numpy()
    out["chimera2048_no_pool"] = {
        "device_seconds": time.perf_counter() - t0,
        "candidates": int(Sc.shape[0]),
        "best_f64": float(c.energy(Sc64[0])),
        "min_one_flip_dE_f64": _min_one_flip_dE(c.J, Sc64)}
    check(out["chimera2048_no_pool"]["min_one_flip_dE_f64"] >= -1e-5,
          "chimera 16x16 device candidates not 1-flip stable")
    emit(out)


def phase_solve_wishart():
    """`python -m nmc_tpu_torch solve` at its defaults on the planted
    wishart N = 40 in a wishart folder with its gs_energies.txt: the
    spectral stage hits, so no MCMC and no kernel launch."""
    import os
    import tempfile
    from nmc_tpu_torch.io.generators import wishart_planted
    prob, t, e = wishart_planted(40, 0.5, seed=0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_solve_") as tmp:
        paths = _write_wishart_folder(
            os.path.join(tmp, "wishart_planting_N_40_alpha_0.50"), 40,
            {"w": (prob.J, t, e)})
        state = os.path.join(tmp, "s.txt")
        rc, rec, seconds, counts, _ = _cli(
            ["solve", paths["w"], "--save-state", state, "--device", DEVICE])
        s = np.loadtxt(state)
    _check_solve_record("solve_wishart", rec, ["presolve", "spectral"])
    check(rc == 0 and rec["hit"] and rec["target_raw"] == e,
          f"solve_wishart: exit {rc}, {rec}")
    check(abs(prob.energy(s) - rec["energy_raw"]) <= 1e-12,
          "solve_wishart: the saved state's energy")
    check(not any(counts.values()), f"solve_wishart launches {counts}")
    emit({"phase": "solve_wishart", "N": 40, "hit": rec["hit"],
          "energy_raw": rec["energy_raw"], "seconds": seconds,
          "wall_seconds": rec["wall_seconds"],
          "stage_seconds": _stage_seconds(rec)})


def phase_solve_contrived():
    """`portfolio_solve` on a contrived Wishart backbone at the
    contrived_n50_a0.20 family's size (50-spin core, 350 spins), no target,
    one MCMC round: presolve peels the trees, the spectral stage and the
    spectral-seeded icm arm (uncoloured: the plain route, whose pure-ICM
    sweeps are one sequential_sweeps launch per instance and round) run on
    the core, and the tree stage is skipped (not a grid). Returns its
    launches."""
    import contextlib
    import io
    import torch
    from nmc_tpu_torch.io.generators import contrived_wishart_backbone
    from nmc_tpu_torch.portfolio import portfolio_solve
    prob, t, e = contrived_wishart_backbone(50, 0.2, seed=0)
    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = portfolio_solve(prob, None, name="contrived_n50_a0.20",
                              sweeps=576, device=DEVICE)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    stages = [s.stage for s in res.stages]
    check(stages == ["presolve", "spectral", "mcmc:icm"],
          f"solve_contrived stages {stages}")
    core_n = res.stages[0].detail["core_n"]
    check(core_n < prob.n, f"presolve kept {core_n} of {prob.n}")
    check(res.state.shape == (prob.n,)
          and float(prob.energy(res.state)) == res.energy_raw,
          "solve_contrived: energy_raw is not the f64 energy of the state")
    check_swaps(counts, res.stages[2].detail["rounds"], "solve_contrived")
    check(counts["sequential_sweeps"] >= 1
          and sum(others(counts, "label_swaps").values())
          == counts["sequential_sweeps"],
          f"solve_contrived launches {counts}")
    emit({"phase": "solve_contrived", "N": prob.n, "core_n": core_n,
          "reduced": {"sweeps": [200000, 576]},
          "energy_raw": res.energy_raw, "planted_energy": e,
          "seconds": seconds,
          "stage_seconds": {s.stage: s.wall_seconds for s in res.stages},
          "launches": counts["sequential_sweeps"],
          "engine": [ln for ln in buf.getvalue().splitlines()
                     if ln.startswith(("engine:", "spectral seeding"))]})
    return counts["sequential_sweeps"]


def phase_solve_chimera2048():
    """`solve --kind chimera --sweeps 11520` on chimera_graph(16, 16) in the
    chimera dialect (no ground-state file: no target): presolve, the icm
    arm through K5 (one launch per round, 20 rounds), the tree stage; the
    spectral stage is skipped (degree 6 <= 16). Each stage's seconds, and
    the MCMC stage's host spectral seeding apart."""
    import os
    import re
    import tempfile
    from nmc_tpu_torch.io.generators import chimera_graph
    prob = chimera_graph(16, 16, seed=0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_c2048_") as tmp:
        path = os.path.join(tmp, "001.txt")
        _write_chimera(path, prob)
        state = os.path.join(tmp, "s.txt")
        rc, rec, seconds, counts, text = _cli(
            ["solve", path, "--kind", "chimera", "--sweeps", "11520",
             "--dm-starts", "0", "--save-state", state, "--device", DEVICE])
        s = np.loadtxt(state)
    _check_solve_record("solve_chimera2048", rec,
                        ["presolve", "mcmc:icm", "tree"])
    check(rc == 0 and rec["target_raw"] is None, f"exit {rc}")
    check("round_path=K5" in text, "the MCMC stage did not take K5")
    rounds = rec["stages"][1]["rounds"]
    check_swaps(counts, rounds, "solve_chimera2048")
    check(rounds == 20 and counts["ensemble_round_sparse"] == rounds
          and not any(others(counts, "ensemble_round_sparse",
                             "label_swaps").values()),
          f"{rounds} rounds, launches {counts}")
    check(abs(prob.energy(s) - rec["energy_raw"]) <= 1e-9,
          "solve_chimera2048: the saved state's energy")
    seeding = re.search(r"spectral seeding: .* in ([0-9.]+)s", text)
    # not the main path: the MCMC stage's engine alone (one instance x 320
    # slots), its per-round split and one K5 round by CUDA events
    import torch
    _, ens, _ = _icm_ensemble(16, 1)
    state = ens.run_scanned(
        ens.init_state(torch.Generator(device=DEVICE).manual_seed(0)), 2)
    timings = {}
    state = ens.run_scanned(state, 4, timings=timings)
    ens.flush()
    one = {"split_seconds_per_round": _per_round(timings),
           "k5_alone": _icm_kernel_ms(torch, ens, state)}
    emit({"phase": "solve_chimera2048", "N": prob.n,
          "reduced": {"sweeps": [200000, 11520], "dm_starts": [2048, 0]},
          "launches": counts["ensemble_round_sparse"], "rounds": rounds,
          "energy_raw": rec["energy_raw"], "seconds": seconds,
          "wall_seconds": rec["wall_seconds"],
          "stage_seconds": _stage_seconds(rec),
          "mcmc_seeding_seconds": float(seeding.group(1)) if seeding
          else None,
          "tree": {k: rec["stages"][2][k] for k in ("moves", "ils_iters")},
          "one_instance_engine": one,
          "engine": [ln for ln in text.splitlines()
                     if ln.startswith("engine:")]})
    return counts["ensemble_round_sparse"]


def phase_refine_128():
    """The `refine` command on chimera_graph(4, 4) from a random state,
    its target the port's exact tropical DP: a hit, with moves."""
    import os
    import tempfile
    from nmc_tpu_torch.exact_chimera import solve_exact_chimera
    from nmc_tpu_torch.io.generators import chimera_graph
    prob = chimera_graph(4, 4, seed=0)
    t0 = time.perf_counter()
    e_gs, _ = solve_exact_chimera(prob)
    dp_seconds = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_refine_") as tmp:
        path = os.path.join(tmp, "001.txt")
        _write_chimera(path, prob)
        s0 = os.path.join(tmp, "s0.txt")
        np.savetxt(s0, np.random.default_rng(0).choice([-1, 1], prob.n),
                   fmt="%d")
        out = os.path.join(tmp, "s.txt")
        rc, rec, seconds, counts, _ = _cli(
            ["refine", path, "--kind", "chimera", "--state", s0, "--target",
             repr(e_gs), "--save-state", out, "--device", DEVICE])
        s = np.loadtxt(out)
    check(set(rec) == REFINE_KEYS, f"refine keys {sorted(rec)}")
    check(rc == 0 and rec["hit"] is True and rec["moves"] > 0,
          f"refine_128: exit {rc}, {rec}")
    check(float(prob.energy(s)) == e_gs, "refine_128: the saved state")
    check(not any(counts.values()), f"refine launches {counts}")
    emit({"phase": "refine_128", "N": prob.n, "target": e_gs,
          "dp_seconds": dp_seconds, "seconds": seconds,
          **{k: rec[k] for k in ("e_int_start", "e_int", "moves",
                                 "ils_iters", "hit")}})


def phase_campaign_spectral():
    """The campaign CLI in process: (1) the icm arm with --init spectral
    --presolve on the 16-spin chimera family (K4), (2) the spectral arm on
    a wishart folder at N = 40, (3) the icm arm with --init file from run
    1's --save-best-states: every instance of each a hit."""
    import os
    import tempfile
    from nmc_tpu_torch.io.generators import wishart_planted
    out = {"phase": "campaign_spectral"}
    launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cspec_") as tmp:
        folder = os.path.join(tmp, "family")
        os.makedirs(folder)
        gs = _write_chimera_family(folder)
        states = os.path.join(tmp, "states")
        wfolder = os.path.join(tmp, "wishart_planting_N_40_alpha_0.50")
        winsts = {k: wishart_planted(40, 0.5, seed=k) for k in range(3)}
        wpaths = _write_wishart_folder(
            wfolder, 40, {k: (p.J, t, e) for k, (p, t, e) in winsts.items()})
        wgs = {os.path.basename(wpaths[k]): e
               for k, (_, _, e) in winsts.items()}
        runs = (
            ("icm_spectral_presolve", folder, gs, "ensemble_round",
             ["--kind", "chimera", "--arm", "icm", "--init", "spectral",
              "--presolve", "--save-best-states", states]),
            ("spectral_arm", wfolder, wgs, None,
             ["--kind", "wishart", "--arm", "spectral", "--spectral-dm",
              "512", "--spectral-dm-iters", "800"]),
            ("icm_file", folder, gs, "ensemble_round",
             ["--kind", "chimera", "--arm", "icm", "--init", "file",
              "--init-states", states]))
        for tag, fold, truth, kernel, flags in runs:
            path = os.path.join(tmp, f"{tag}.jsonl")
            rc, _, seconds, counts, text = _cli(
                ["campaign", "--folder", fold, *flags, "--out", path,
                 "--device", DEVICE])
            with open(path) as f:
                recs = [json.loads(line) for line in f]
            check(sorted(r["name"] for r in recs) == sorted(truth),
                  f"{tag}: records do not cover the folder")
            check(all(r["hit"] and abs(r["found_raw"] - truth[r["name"]])
                      <= 1e-9 for r in recs), f"{tag} missed a ground state")
            check_swaps(counts, counts[kernel] if kernel else 0, tag)
            check((kernel is None or counts[kernel] > 0)
                  and not any(others(counts, kernel, "label_swaps").values()),
                  f"{tag}: launches {counts}")
            if tag == "icm_spectral_presolve":
                check("round_path=K4" in text, f"{tag} did not take K4")
                check(all(r["meta"]["init"] == "spectral"
                          and r["meta"]["presolve"] == "peel"
                          for r in recs), f"{tag}: meta")
            if tag == "icm_file":
                check(all(r["meta"]["init"] == "file" for r in recs),
                      f"{tag}: meta")
            launches += counts["ensemble_round"]
            out[tag] = {"instances": len(recs), "hits": len(recs),
                        "kernel": kernel, "launches": counts.get(kernel, 0),
                        "seconds": seconds,
                        "hit_sweeps": [r["hit_sweeps"] for r in recs]}
    emit(out)
    return launches


BEAM_KEYS = {"name", "n", "kind", "rows", "cols", "beam", "energy_raw",
             "exact", "strip_moves", "wall_seconds", "shipped_target",
             "reaches_shipped"}


def _chimera_q(rows, cols, q, seed):
    """chimera_graph(rows, cols)'s edges with Gaussian couplings rounded to
    multiples of 1/q (q = 75: the droplet families' grid), no fields."""
    from nmc_tpu_torch.core.problem import IsingProblem
    from nmc_tpu_torch.io.generators import chimera_graph
    A = np.triu(chimera_graph(rows, cols, seed=seed).J != 0, 1)
    g = np.random.default_rng(seed + 1000).normal(size=A.shape)
    J = A * np.round(g * q) / q
    return IsingProblem(J + J.T, np.zeros(A.shape[0]))


def phase_beam_parity():
    """Not a main path: the device beam's DP (`run_beam`, torch's stable
    sorts) on the card against the same function on CPU tensors, bit for
    bit in (E_fin, parents, combos), on +-J chimera 4x4 at beam 2^12 and
    8x8 at 2^10, split 1 and 2; then the unpruned 4-row by 3-column grid
    (16^4 boundary states) at beam 2^16, Gaussian couplings on the 1/75
    grid: `e_int` equal to the exact tropical DP's optimum."""
    import torch
    from nmc_tpu_torch import beam_chimera_cuda as bc
    from nmc_tpu_torch.exact_chimera import solve_exact_chimera
    from nmc_tpu_torch.io.generators import chimera_graph
    out = {"phase": "beam_parity", "cases": []}
    for size, log2 in ((4, 12), (8, 10)):
        prob = chimera_graph(size, size, seed=size)
        Jq, hq, _ = bc.quantize_problem(prob)
        trans = torch.from_numpy(bc._int_cell_tables(Jq, hq, size, size))
        for split in (1, 2):
            t0 = time.perf_counter()
            dev = bc.run_beam(trans.to(DEVICE), size, size, 1 << log2, split)
            dev = [x.cpu() for x in dev]
            t1 = time.perf_counter()
            host = bc.run_beam(trans, size, size, 1 << log2, split)
            t2 = time.perf_counter()
            for name, a, b in zip(("E_fin", "parents", "combos"), dev,
                                  host):
                check(a.dtype == b.dtype and torch.equal(a, b),
                      f"beam_parity {size}x{size} 2^{log2} split {split}: "
                      f"{name} differs from the CPU run")
            out["cases"].append({"grid": size, "beam": 1 << log2,
                                 "split": split, "equal": True,
                                 "device_seconds": t1 - t0,
                                 "cpu_seconds": t2 - t1})
    prob = _chimera_q(4, 3, 75, seed=3)
    e_ref, _ = solve_exact_chimera(prob, rows=4, cols=3)
    e, s, info = bc.solve_beam_chimera_cuda(prob, rows=4, cols=3,
                                            beam=1 << 16, device=DEVICE)
    check(info["q"] == 75 and info["e_int"] == int(round(e_ref * 75)),
          f"beam_parity 4x3: e_int {info['e_int']} against the exact "
          f"{e_ref * 75}")
    check(abs(float(prob.energy(s)) - e) <= 1e-9, "beam_parity 4x3: state")
    out["unpruned_4x3"] = {"beam": 1 << 16, "e_int": info["e_int"],
                           "exact_e_int": int(round(e_ref * 75)),
                           "energy": e}
    emit(out)


def phase_beam_2048():
    """The `beam` CLI on the card on a generated chimera 16x16 (Gaussian
    couplings on the 1/75 grid) in the chimera dialect: --beam 16
    --no-refine, --beam 17 --no-refine (split 2), --beam 16 with window-8
    strip refinement (the strips' sub-solver the device beam at 2^15). Each
    record's energy is the f64 energy of its saved state, the refined one
    at or below the beam's; no kernel launches. Then the device DP alone
    (`run_beam`) at 2^16 and 2^17: ms per cell, the share of its stable
    sorts (CUDA events around each `torch.sort` call of the run), peak
    device memory, its optimum equal to the CLI record's energy."""
    import os
    import tempfile
    import torch
    from nmc_tpu_torch import beam_chimera_cuda as bc
    prob = _chimera_q(16, 16, 75, seed=0)
    out = {"phase": "beam_2048", "N": prob.n}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_beam_") as tmp:
        path = os.path.join(tmp, "001.txt")
        _write_chimera(path, prob)
        for tag, flags in (("beam16", ["--beam", "16", "--no-refine"]),
                           ("beam17", ["--beam", "17", "--no-refine"]),
                           ("beam16_refined", ["--beam", "16"])):
            state = os.path.join(tmp, f"{tag}.txt")
            torch.cuda.reset_peak_memory_stats()
            rc, rec, seconds, counts, _ = _cli(
                ["beam", path, "--kind", "chimera", *flags,
                 "--save-state", state, "--device", DEVICE])
            peak = torch.cuda.max_memory_allocated()
            s = np.loadtxt(state)
            check(rc == 0 and set(rec) == BEAM_KEYS,
                  f"{tag}: exit {rc}, keys {sorted(rec)}")
            check((rec["rows"], rec["cols"]) == (16, 16)
                  and np.isfinite(rec["energy_raw"]),
                  f"{tag}: {rec}")
            check(abs(float(prob.energy(s)) - rec["energy_raw"]) <= 1e-9,
                  f"{tag}: the saved state's f64 energy")
            check(not any(counts.values()), f"{tag}: launches {counts}")
            out[tag] = {"energy_raw": rec["energy_raw"],
                        "strip_moves": rec["strip_moves"],
                        "wall_seconds": rec["wall_seconds"],
                        "seconds": seconds, "peak_bytes": peak}
        check(out["beam16_refined"]["energy_raw"]
              <= out["beam16"]["energy_raw"] + 1e-9,
              "beam_2048: refinement raised the energy")
    Jq, hq, q = bc.quantize_problem(prob)
    t0 = time.perf_counter()
    trans = bc._int_cell_tables(Jq, hq, 16, 16)
    tables_seconds = time.perf_counter() - t0
    trans = torch.from_numpy(trans).to(DEVICE)
    sort, marks = torch.sort, []

    def timed_sort(*args, **kwargs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res = sort(*args, **kwargs)
        ev[1].record()
        marks.append(ev)
        return res

    for log2 in (16, 17):
        M = 1 << log2
        marks.clear()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        torch.sort = timed_sort
        try:
            ev[0].record()
            E_fin, _, _ = bc.run_beam(trans, 16, 16, M, bc.auto_split(M))
            ev[1].record()
        finally:
            torch.sort = sort
        torch.cuda.synchronize()
        beam_ms = ev[0].elapsed_time(ev[1])
        sort_ms = sum(a.elapsed_time(b) for a, b in marks)
        e_int = int(E_fin.min())
        check(e_int == round(out[f"beam{log2}"]["energy_raw"] * q),
              f"beam 2^{log2}: run_beam's optimum {e_int} / {q}")
        out[f"timed{log2}"] = {
            "split": bc.auto_split(M), "q": q, "sorts": len(marks),
            "ms_per_cell": beam_ms / 256,
            "sort_ms_per_cell": sort_ms / 256,
            "sort_share": sort_ms / beam_ms,
            "tables_seconds": tables_seconds,
            "peak_bytes": torch.cuda.max_memory_allocated()}
    emit(out)


def phase_evaluate_512():
    """The `evaluate` CLI with --coloring on a generated chimera512 folder:
    three +-J chimera 8x8 instances in the chimera dialect, their targets
    in groundstates_otn2d.txt from the device beam at 2^16 (an upper bound
    on the ground state). First at its defaults (12 replicas, 2000 sweeps
    in 20 swap rounds), then at 100000 sweeps in 1000 swap rounds, where
    at least one instance must reach its target. Every sweep through K1;
    one report line per instance, finite energies in raw units. Returns
    K1's launches."""
    import os
    import tempfile
    from nmc_tpu_torch.beam_chimera_cuda import solve_beam_chimera_cuda
    from nmc_tpu_torch.io.generators import chimera_graph
    out, launches = {"phase": "evaluate_512", "N": 512}, 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        lines = []
        for k in range(3):
            prob = chimera_graph(8, 8, seed=k)
            name = f"{k + 1:03d}.txt"
            _write_chimera(os.path.join(tmp, name), prob)
            e, s, _ = solve_beam_chimera_cuda(prob, beam=1 << 16,
                                              device=DEVICE)
            bits = " ".join(str(int(x)) for x in (s + 1) // 2)
            lines.append(f"{name} : {e!r} {bits}\n")
        with open(os.path.join(tmp, "groundstates_otn2d.txt"), "w") as f:
            f.writelines(lines)
        for tag, budget in (("defaults", []),
                            ("sweeps_100000", ["--sweeps", "100000",
                                               "--swap-attempts", "1000"])):
            rc, rep, seconds, counts, _ = _cli(
                ["evaluate", "--folder", tmp, "--family", "chimera",
                 "--coloring", "--device", DEVICE, *budget])
            insts = rep["instances"]
            check(rc is None and [i["name"] for i in insts]
                  == ["001.txt", "002.txt", "003.txt"],
                  f"evaluate {tag}: {rep}")
            check(all(np.isfinite(i["found_energy"]) and i["sweeps_used"] == 0
                      for i in insts), f"evaluate {tag}: energies")
            check(counts["colored_sweeps"] > 0
                  and all(v == 0 for k, v in counts.items()
                          if k != "colored_sweeps"),
                  f"evaluate {tag}: launches {counts}")
            check(tag == "defaults" or any(i["hit"] for i in insts),
                  f"evaluate {tag}: no instance reached its target")
            launches += counts["colored_sweeps"]
            out[tag] = {"launches": counts["colored_sweeps"],
                        "seconds": seconds,
                        "hit_rate": rep["summary"]["hit_rate"],
                        "found_minus_target": [
                            i["found_energy"] - i["gs_energy"]
                            for i in insts],
                        "seconds_per_instance": [i["seconds"]
                                                 for i in insts]}
    emit(out)
    return launches


def phase_exact_enum(k6_energy):
    """`solve_exact_enum` (host: the g++-built enum.cpp, its incumbent the
    host spectral search) on exact_40's float instance: a proof, with the
    energy K6 gave in exact_40; the build, the nodes and the seconds."""
    from nmc_tpu_torch import native
    from nmc_tpu_torch.core.problem import IsingProblem
    from nmc_tpu_torch.exact import solve_exact_enum
    J, t, e = _exact40()["float"]
    t0 = time.perf_counter()
    native.load_enum_library()
    build = time.perf_counter() - t0
    nodes = []
    enumerate_ = native.exact_enumerate

    def counted(*a, **k):
        res = enumerate_(*a, **k)
        nodes.append(res[3])
        return res

    native.exact_enumerate = counted
    try:
        t0 = time.perf_counter()
        e_enum, s, proved = solve_exact_enum(IsingProblem(J, np.zeros(40)))
        seconds = time.perf_counter() - t0
    finally:
        native.exact_enumerate = enumerate_
    check(proved and e_enum == k6_energy,
          f"enum: {e_enum} (proved {proved}) against K6's {k6_energy}")
    check(np.array_equal(s, t) or np.array_equal(s, -t),
          "enum: not the planted state")
    emit({"phase": "exact_enum", "N": 40, "proved": bool(proved),
          "energy_raw": e_enum, "k6_energy_raw": k6_energy,
          "nodes": nodes[0], "seconds": seconds, "build_seconds": build})


def _event_ms(torch, fn):
    """(ms of one call of fn by CUDA events, its result)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), res


def _state_of(out, layout):
    """The state of the table's least row (first on ties) and its argmin,
    as `solve_exact_fused` reads it."""
    from nmc_tpu_torch.exact import _state
    a, b, symmetry = layout[:3]
    min_e = out[0].cpu().numpy()
    ra = int(np.argmin(min_e))
    return _state(a, b, symmetry, ra, int(out[1][ra]))


def _entries64(args, rows, cols):
    """K6's table entries T[rows, cols] in f64 from its f32 inputs."""
    SA, C, EA, EB = args
    return (EA[rows].double() + EB[cols].double()
            - (SA[rows].double() * C[:, cols].T.double()).sum(1))


def _compare_exact40(torch, tag, k, p, args, layout, inst, tol):
    """K6/K7's (min_e, arg_b) `k` against its plain version's `p` at
    N = 40. tol = 0 (integer couplings): both equal element for element,
    pad rows included. tol > 0 (float couplings, K6): the same rows
    finite; min_e within tol; the kernel's min within tol of the f64 entry
    at its own argmin; where the argmins differ, the two columns' f64
    entries within 2 tol (a near-tie). Then both give the planted state
    with its f64 energy. Returns max |min_e difference| over live rows."""
    from nmc_tpu_torch.core.problem import IsingProblem
    J, t, e = inst
    live = torch.isfinite(p[0].double())
    if tol == 0:
        n_e = int((k[0] != p[0]).sum())
        n_b = int((k[1] != p[1]).sum())
        check(n_e == 0 and n_b == 0, f"{tag}: {n_e} minima and {n_b} "
              "argmins differ from the plain version")
        res = {"min_and_argmin_equal": True}
    else:
        check(torch.equal(live, torch.isfinite(k[0])), f"{tag}: pad rows")
        rows = torch.nonzero(live).squeeze(1)
        err = float((k[0][rows].double() - p[0][rows].double()).abs().max())
        own = float((_entries64(args, rows, k[1][rows].long())
                     - k[0][rows].double()).abs().max())
        moved = rows[k[1][rows] != p[1][rows]]
        gap = (float((_entries64(args, moved, k[1][moved].long())
                      - _entries64(args, moved, p[1][moved].long()))
                     .abs().max()) if moved.numel() else 0.0)
        check(err <= tol and own <= tol and gap <= 2 * tol,
              f"{tag}: min_e off by {err}, own entry by {own}, argmin "
              f"near-tie gap {gap} (tol {tol})")
        res = {"tol": tol, "max_min_e_diff": err, "max_own_entry_diff": own,
               "argmin_rows_differ": int(moved.numel()),
               "max_argmin_gap": gap}
    prob = IsingProblem(J, np.zeros(J.shape[0]))
    for who, out in (("kernel", k), ("plain", p)):
        s = _state_of(out, layout)
        check(np.array_equal(s, t) and float(prob.energy(s)) == e,
              f"{tag}: the {who} version misses the planted state")
    res["planted_state_and_f64_energy"] = True
    err = float((k[0][live].double() - p[0][live].double()).abs().max())
    return res, err


def _throughput_exact(torch, name):
    """K6 (planes off) or K7 at N = 40 on the integer planted wishart of
    the main path, one call per timing, in turns with the plain version
    (plain, kernel, kernel, plain; the plain version tiles by 4096 x
    65536), each kernel call's output held against each plain call's
    (`_compare_exact40`). The kernel runs on operands packed once before
    (`_pack_f32` / `_pack_i8`, timed apart as `pack_ms`: the fused solver
    packs them with the upload). K6 then once more on the float planted
    wishart, against its plain version with tol = 128 * 2^-24 * the energy
    bound (each f32 entry sums 22 terms of at most the bound, rounded in
    different orders). The bound counts the work the function needs in
    this design, per table entry: on the tensor cores 2 * 3a bf16
    operations for K6 (the three bf16 parts of C, depth 3a, not the padded
    depth) and 2 * a int8 operations per digit plane for K7; on the CUDA
    cores at the f32 rate one min for K6, and for K7 one min plus one
    shift-and-add per plane past the first (EB starts the accumulator and
    EA is added once per row, after the min); the larger of the two. K6's
    bound on the CUDA cores alone (2a + 3 operations per entry, the PR 4
    design without the tensor cores) is kept beside it. Bytes: each input
    once, the two outputs once. Registers, shared memory and CTAs per SM
    from the CUDA runtime."""
    from nmc_tpu_torch.exact import exact_energy_bound
    from nmc_tpu_torch.ops import exact_cuda as ec
    planes = "on" if name == "mitm_min_i8" else "off"
    inst = _exact40()["int"]
    use_i8, args, layout = _exact_args(torch, inst[0], planes)
    _, kernel, plain = _exact_fns(use_i8)
    pack, launch = ((ec._pack_i8, ec._launch_i8) if use_i8
                    else (ec._pack_f32, ec._launch_f32))
    SA, C, EA, EB = args
    TA, a = SA.shape
    TB = EB.shape[0]
    total_a = 1 << (layout[0] - 1)
    blocks = dict(block_a=4096, block_b=65536)
    pack_ms, packed = _event_ms(torch, lambda: pack(
        *args, block_a=layout[3], block_b=layout[4]))
    launch(*packed)                                      # warm-up
    times = {"kernel": [], "plain": []}
    outs = {"kernel": [], "plain": []}
    for turn in ("plain", "kernel", "kernel", "plain"):
        fn = (lambda: launch(*packed)) if turn == "kernel" else (
            lambda: plain(*args, **blocks))
        ms, res = _event_ms(torch, fn)
        times[turn].append(ms)
        outs[turn].append(res)
    max_err = 0.0
    for k in outs["kernel"]:
        for p in outs["plain"]:
            res, err = _compare_exact40(torch, f"{name} N = 40 int", k, p,
                                        args, layout, inst, 0)
            max_err = max(max_err, err)
    checks = {"int": res}
    float_run = None
    if not use_i8:
        finst = _exact40()["float"]
        _, fargs, flayout = _exact_args(torch, finst[0], "off")
        tol = 128 * 2.0 ** -24 * exact_energy_bound(finst[0])
        fk_ms, fk = _event_ms(torch, lambda: kernel(*fargs))
        fp_ms, fp = _event_ms(torch, lambda: plain(*fargs, **blocks))
        checks["float"], err = _compare_exact40(
            torch, f"{name} N = 40 float", fk, fp, fargs, flayout, finst, tol)
        max_err = max(max_err, err)
        float_run = {"kernel_ms_with_packing": fk_ms, "plain_ms": fp_ms}
    entries = total_a * TB
    kd = packed[0].shape[1]
    if use_i8:
        K = C.shape[0]
        depth = a * K
        t_tc = 2 * depth * entries / PEAK_INT8_OPS
        t_epi = K * entries / PEAK_F32_OPS
        nbytes = SA.numel() + C.numel() + 4 * (TA + TB) + 8 * TA
        t_cuda_cores = None
    else:
        K = None
        depth = 3 * a
        t_tc = 2 * depth * entries / PEAK_BF16_OPS
        t_epi = entries / PEAK_F32_OPS
        nbytes = 4 * (SA.numel() + C.numel() + TA + TB) + 8 * TA
        t_cuda_cores = (2 * a + 3) * entries / PEAK_F32_OPS
    t_ops = max(t_tc, t_epi)
    t_bytes = nbytes / PEAK_HBM_BYTES
    k_ms, p_ms = min(times["kernel"]), min(times["plain"])
    regs, smem, ctas = ec.kernel_occupancy(use_i8, K if use_i8 else kd)
    return {"name": name, "N": 40, "a": a, "TA": TA, "TB": TB,
            "digit_planes": K, "packed_depth": kd, "bound_depth": depth,
            "table_entries": entries,
            "ms": times, "pack_ms": pack_ms,
            "kernel_ms_per_call": k_ms, "plain_ms_per_call": p_ms,
            "checks": checks, "max_abs_err": max_err, "float": float_run,
            "kernel_entries_per_s": entries / (k_ms * 1e-3),
            "registers": regs, "shared_bytes": smem, "ctas_per_sm": ctas,
            "bound_tensor_core_ms": 1e3 * t_tc,
            "bound_epilogue_ms": 1e3 * t_epi,
            "bound_cuda_cores_only_ms": (1e3 * t_cuda_cores
                                         if t_cuda_cores else None),
            "bound_bytes": nbytes, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "share_of_bound": max(t_ops, t_bytes) / (k_ms * 1e-3)}


# ---- throughput and bounds ---------------------------------------------------

def _timed_ms(torch, step, m, iters):
    """Mean ms per call of `step` over `iters` calls, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        m = step(m)
    end.record()
    torch.cuda.synchronize()
    check(np.isfinite(float(m.phi.sum())), "non-finite fields")
    return start.elapsed_time(end) / iters, m


def _throughput_one(torch, name, prob, eng, R, sweeps, iters, beta=2.0,
                    with_plain=True):
    """Kernel and plain version in turns (plain, kernel, kernel, plain) on
    one layout; flips per attempt from single-sweep kernel calls; the
    least time the card could take for one call's work. with_plain=False:
    the kernel alone (two timed turns, no hot-beta probe)."""
    from nmc_tpu_torch.ops import sweeps_cuda as sc
    from nmc_tpu_torch.ops.sweeps_cuda import ColoredSweepResult
    n_pad = eng.n_pad
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    m0 = eng.init_states(gen, R)
    betas = torch.full((sweeps,), beta, device=DEVICE)
    if name == "colored_sweeps":
        one = torch.ones((), device=DEVICE)

        def call(fn, m, T):
            return fn(eng.J_full, eng.h, m.m, m.phi, gen, betas[:T], one,
                      eng.active[None], num_sweeps=T,
                      block_size=eng.blocked.block_size)
        fns = (functools.partial(sc.colored_sweeps, nbrs=eng.sweep_nbrs),
               sc.colored_sweeps_reference)
        P, threads = sc.k1_launch(R, n_pad, sc._num_sms(DEVICE))
    elif name == "sequential_sweeps":
        from nmc_tpu_torch.ops.sweeps import run_sweeps
        one = torch.ones((), device=DEVICE)

        def call(fn, m, T):
            return fn(eng.J_rows, eng.J_diag, eng.h, m.m, m.phi, gen,
                      betas[:T], one, eng.active[None], num_sweeps=T)
        fns = (functools.partial(sc.sequential_sweeps, nbrs=eng.sweep_nbrs),
               functools.partial(run_sweeps, within_block="sequential"))
        P, n_buf = sc.sequential_launch(1, R, n_pad, eng.blocked.block_size,
                                        sc._num_sms(DEVICE))
        threads = sc.SEQ_WIDTH
    else:
        fns = _kernel_fns(name, eng)
        ones = torch.ones(R, device=DEVICE)

        def call(fn, m, T):
            return fn(eng.h, m.m, m.phi, gen, betas[:T], ones,
                      eng.active[None], None, num_sweeps=T)
        P, threads = 1, sc.sweep_threads(R, sc._num_sms(DEVICE))
    # all read the couplings only through the neighbour layout (the
    # sequential kernel also the diagonal tiles), a [1, n_pad] mask and
    # beta_row (K1: its scalar beta_spin)
    j_bytes = sum(t.numel() * t.element_size() for t in eng.sweep_nbrs
                  if isinstance(t, torch.Tensor))
    if name == "sequential_sweeps":
        j_bytes += eng.J_diag.numel() * 4
    mask_bytes = n_pad + 4 * R
    state = ColoredSweepResult(m0, eng.fields(m0), None, None, None)
    kernel, plain = fns
    state = call(kernel, state, sweeps)        # burn-in (and warm-up)
    if with_plain:
        state = call(plain, state, sweeps)
    times = {"kernel": [], "plain": []}
    turns = (("plain", "kernel", "kernel", "plain") if with_plain
             else ("kernel", "kernel"))
    for turn in turns:
        fn = kernel if turn == "kernel" else plain
        ms, state = _timed_ms(torch, lambda s: call(fn, s, sweeps), state,
                              iters)
        times[turn].append(ms)
    N = prob.n

    def measure_flips(state):
        """Flips per attempt: one sweep per call, spins that changed."""
        flips, calls = 0, 32
        for _ in range(calls):
            nxt = call(kernel, state, 1)
            flips += int((nxt.m != state.m).sum())
            state = nxt
        return flips / (calls * R * N), state

    rate, state = measure_flips(state)
    hot_ms = hot_rate = None
    if with_plain:
        # the same kernel at a hot beta, where far more spins flip: if the
        # time per call grows much less than the J-row traffic of the flips,
        # the phi update's L2 (or HBM) bytes are not what bounds it at beta
        betas.fill_(HOT_BETA)
        hot_ms, state = _timed_ms(torch, lambda s: call(kernel, s, sweeps),
                                  state, 1)
        hot_rate, state = measure_flips(state)
    attempts = R * sweeps * N
    degree = np.count_nonzero(prob.J) / N
    ops = (attempts * OPS_PER_ATTEMPT + attempts * rate * 2 * degree
           + 3 * R * sweeps * n_pad)
    nbytes = (j_bytes + 4 * n_pad + mask_bytes + 4 * sweeps   # J, h, masks
              + 2 * 4 * R * n_pad                             # m0, phi0
              + 3 * 4 * R * n_pad + 4 * R + 4 * sweeps * R)   # outputs
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_HBM_BYTES
    k_ms = min(times["kernel"])
    p_ms = min(times["plain"]) if with_plain else None
    if name == "sequential_sweeps":
        # a step is a row block: two CTA barriers each
        regs, ctas = sc.sequential_occupancy(
            n_pad, eng.blocked.block_size, P, n_buf)
        steps = eng.blocked.num_blocks
    else:
        regs, ctas = sc.sweep_occupancy(n_pad, threads, P)
        steps = int(eng.sweep_nbrs.step_ptr.shape[0]) - 1
    return {"name": name, "R": R, "steps_per_sweep": steps,
            "kernel_us_per_step": 1e3 * k_ms / (sweeps * steps), "sweeps": sweeps, "iters": iters, "N": N,
            "n_pad": n_pad, "threads": threads, "replicas_per_cta": P,
            "registers": regs, "ctas_per_sm": ctas, "beta": beta, "ms": times,
            "kernel_ms_per_call": k_ms, "plain_ms_per_call": p_ms,
            "kernel_attempts_per_s": attempts / (k_ms * 1e-3),
            "plain_attempts_per_s": attempts / (p_ms * 1e-3) if p_ms else None,
            "flips_per_attempt": rate,
            "flips_per_sweep_per_replica": rate * N,
            "hot": {"beta": HOT_BETA, "kernel_ms_per_call": hot_ms,
                    "flips_per_attempt": hot_rate},
            "mean_degree": degree, "bound_ops": ops, "bound_bytes": nbytes,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


# The shapes the sweep kernels launch at on the main paths (phases 5-8):
# (replicas R, sweeps per timed call, launches, sweeps over all launches).
# K1: nmc_512's nmc_run, 1 x 2000 + 9 x 500 sweeps at R = 256; K2:
# nmc_4096's, 1 x 500 + 3 x 100 at R = 64; K3: nmc_2048's nmc_run at R = 256
# (1 x 2000 + 9 x 500), APT at R = 64 (26 x 200), NPT's PT replicas at
# R = 24 (4 x 300) and its NMC replicas at R = 2 (12 x 100).
LAUNCH_SHAPES = {
    "colored_sweeps": [(256, 500, 10, 6500)],
    "colored_sweeps_streamed": [(64, 100, 4, 800)],
    "colored_sweeps_sparse": [(256, 500, 10, 6500), (64, 200, 26, 5200),
                              (24, 300, 4, 1200), (2, 100, 12, 1200)],
}
# K2's and K3's throughput shape (replicas, sweeps per call), and the
# shapes K1 and K2 are timed at on the denser layout (_dense_layout)
SWEEP_THROUGHPUT = (2048, 256)
DENSE_SHAPES = ((64, 100), (2048, 32))


def _launch_shapes(torch, name, prob, eng):
    """The kernel alone at each of its main-path launch shapes (CUDA
    events, beta 2, two timed calls each), beside the bound of each call;
    `gap_ms`: the main path's launches at that shape times (ms - bound),
    scaled by the sweeps they run against the timed call's."""
    out = []
    for R, sweeps, launches, total in LAUNCH_SHAPES[name]:
        r = _throughput_one(torch, name, prob, eng, R, sweeps, 1,
                            with_plain=False)
        out.append({"R": R, "sweeps": sweeps, "launches": launches,
                    "main_path_sweeps": total,
                    "ms": r["kernel_ms_per_call"], "bound_ms": r["bound_ms"],
                    "flips_per_attempt": r["flips_per_attempt"],
                    "threads": r["threads"],
                    "replicas_per_cta": r["replicas_per_cta"],
                    "registers": r["registers"],
                    "ctas_per_sm": r["ctas_per_sm"],
                    "gap_ms": total / sweeps * (r["kernel_ms_per_call"]
                                                - r["bound_ms"])})
    return out


def _dense_layout(torch):
    """K2 and K1 on a denser colored layout, the union of 32 random +-1
    perfect matchings at N = 4096 (many more colour classes, so steps, than
    chimera's or the 3-regular graph's; the K2 route): K1 = K2 bit for bit
    with one Philox seed, then each kernel alone at R = 64 x 100 and
    R = 2048 x 32 sweeps, K1 at its rule's replicas per CTA (shared memory
    allows at most 4 at n_pad 5248), K2 at one."""
    from nmc_tpu_torch.ops.engine import SweepEngine
    prob = _matchings(4096, 32, 7, "matchings32_4096")
    eng = SweepEngine(prob, use_coloring=True, device=DEVICE)
    check(eng.sweep_kernel == "colored_sweeps_streamed",
          f"32 matchings: route {eng.sweep_kernel}")
    nbrs = eng.sweep_nbrs
    out = {"N": prob.n, "mean_degree": np.count_nonzero(prob.J) / prob.n,
           "n_pad": eng.n_pad, "num_blocks": eng.blocked.num_blocks,
           "steps": int(nbrs.step_ptr.shape[0]) - 1,
           "entries": int(nbrs.src.shape[0])}
    out["k1_k2_bit_equal_philox"] = _equals_k1(
        torch, eng, ("colored_sweeps_streamed",), 64, 8)
    for R, sweeps in DENSE_SHAPES:
        for name in ("colored_sweeps_streamed", "colored_sweeps"):
            r = _throughput_one(torch, name, prob, eng, R, sweeps, 1,
                                with_plain=False)
            out[f"{name} R={R} x {sweeps}"] = {
                k: r[k] for k in ("threads", "replicas_per_cta",
                                  "kernel_ms_per_call", "bound_ms",
                                  "flips_per_attempt", "ms")}
    return out


# ---- the sequential route and the modules on it ------------------------------

# BASELINE config 5: 100 SK-1000 instances x 64 replicas on one card
SK_N, SK_INSTANCES, SK_REPLICAS = 1000, 100, 64
# the sequential route's timed shape: EnsemblePT's launch (R = 64, one
# round of 32 sweeps); the plain version's per-spin loop takes ~0.1 s a
# sweep there, so it is timed at 16
SEQ_SHAPE = (SK_REPLICAS, 16)


def _sk_pm(n, seed):
    """SK with +-1 couplings and no fields (every sum exact in f32)."""
    from nmc_tpu_torch.core.problem import IsingProblem
    rng = np.random.default_rng(seed)
    J = np.triu(rng.choice([-1.0, 1.0], size=(n, n)), 1)
    return IsingProblem(J + J.T, np.zeros(n))


def _sequential_cases():
    """(tag, problem, R, +-1): +-J SK-1000 (n_pad 1024, 8 blocks)
    and Gaussian chimera 8x8 without colouring (n_pad 512)."""
    from nmc_tpu_torch.io.generators import chimera_graph
    return (("sk1000_pm", _sk_pm(SK_N, 0), SK_REPLICAS, True),
            ("chimera512_gauss", chimera_graph(8, 8, seed=5, pm=False)
             .normalized()[0], 256, False))


def _sharded_npt_c_phase(torch):
    """ShardedNPT's phase launch on +-J SK-1000 at the `sharded` CLI's
    defaults (world 1, 32 replicas geomspace 0.25-16, the 2 coldest NMC):
    (engine, states, beta_spin [R, n_pad], update mask [R, n_pad], sweeps)
    of a C phase, the heated backbone of the NMC slots from LBP on a
    random start."""
    from nmc_tpu_torch.parallel import ShardedNPT, ShardedNPTConfig
    R, nmc = 32, 2
    cfg = ShardedNPTConfig(sweeps_per_phase=64, num_cycles=3,
                           num_swapping_pairs=R // 4, global_beta=2.5,
                           temp_x=TEMP_X)
    pt = ShardedNPT(_sk_pm(SK_N, 0), np.geomspace(0.25, 16.0, R),
                    [False] * (R - nmc) + [True] * nmc, cfg, device=DEVICE)
    st = pt.init_state(torch.Generator(device=DEVICE).manual_seed(4))
    cl, dn = pt._clusters(st.m, st.slot_to_beta)
    check(int(dn.sum()) == nmc and bool(cl[dn].any()),
          "sharded_npt C phase: no backbone on the NMC slots")
    bs, mask = pt._phase_args("C", cl, dn, pt._base(st.slot_to_beta, dn))
    return pt.engine, st.m, bs, mask, cfg.sweeps_per_phase


def _icm_round_contrived(torch):
    """The pure-ICM round's launch of `solve_contrived`'s MCMC stage: the
    presolved core of the contrived Wishart backbone (50-spin core, 350
    spins) in an EnsembleICM at the campaign's defaults (32 rungs x 10
    sub-replicas = 320 slots, 576 sweeps, uncoloured): (engine, states,
    beta_spin [320, 1], update mask [320, n_pad], sweeps)."""
    from nmc_tpu_torch.campaign import build_ladder
    from nmc_tpu_torch.core.problem import IsingProblem
    from nmc_tpu_torch.io.generators import contrived_wishart_backbone
    from nmc_tpu_torch.ops.presolve import peel_leaves
    from nmc_tpu_torch.parallel import EnsembleICM, EnsembleICMConfig
    prob, _, _ = contrived_wishart_backbone(50, 0.2, seed=0)
    ps = peel_leaves(np.asarray(prob.J, np.float64),
                     np.asarray(prob.h, np.float64))
    core = IsingProblem(ps.J_core, ps.h_core).normalized()[0]
    cfg = EnsembleICMConfig(sweeps_per_round=576, num_subreplicas=ICM_S,
                            num_swapping_pairs=ENS_R // 4, temp_x=TEMP_X,
                            num_cycles=3)
    ens = EnsembleICM([core], build_ladder(0.25, 32.0, ENS_R), cfg,
                      device=DEVICE)
    check(ens.round_path == "plain"
          and ens._engines[0].sweep_kernel == "sequential_sweeps",
          f"contrived ICM route {ens.round_path}")
    st = ens.init_state(torch.Generator(device=DEVICE).manual_seed(5))
    Rk = ICM_S * ENS_R
    return (ens._engines[0], st.m[0].reshape(Rk, ens.n_pad),
            ens.beta_list[st.slot_to_beta[0]].reshape(Rk, 1),
            ens.active.expand(Rk, ens.n_pad), cfg.sweeps_per_round)


def _seq_twin(torch, eng, m0, phi0, beta, beta_spin, mask, T, u):
    """`sequential_sweeps_reference` (the kernel's association) of one
    engine's launch with the wrapper's beta and mask hand-off, outputs
    without the instance axis."""
    from nmc_tpu_torch.ops import sweeps_cuda as sc
    R, n_pad = m0.shape
    bs = torch.as_tensor(beta_spin, device=m0.device)
    beta_row, spin = sc._k1_betas(bs[None] if bs.ndim else bs, (1, R),
                                   n_pad, m0.device)
    res = sc.sequential_sweeps_reference(
        eng.sweep_nbrs, eng.J_diag[None], eng.h[None], m0[None], phi0[None],
        None, beta, beta_row.reshape(1, R), mask.expand(R, n_pad)[None],
        None if spin is None else spin.reshape(1, R, n_pad), num_sweeps=T,
        uniforms=u[:, None], record_m=True)
    return type(res)(*(x[0] for x in res))


def _hold_sequential(torch, tag, eng, m0, beta, beta_spin, mask, pm, gen,
                     plain_sweeps=None):
    """One `sequential_sweeps` launch with uniforms from `gen`, recorded,
    held against `sequential_sweeps_reference` (the kernel's association)
    bit for bit and against `run_sweeps(within_block="sequential")`: bit
    for bit on +-J couplings (`pm`), else within `_compare`'s tolerance
    with the recorded states of the replicas that agree equal, there over
    the first `plain_sweeps` sweeps (a second launch of as many) when
    given: on Gaussian couplings the two phi orders' f32 roundings split a
    few chains over hundreds of sweeps. Returns (record, error)."""
    from nmc_tpu_torch.ops import sweeps_cuda as sc
    from nmc_tpu_torch.ops.sweeps import run_sweeps
    check(eng.sweep_kernel == "sequential_sweeps",
          f"{tag}: route {eng.sweep_kernel}")
    (R, n_pad), T = m0.shape, beta.shape[0]
    B = eng.blocked.block_size
    phi0 = eng.fields(m0)
    u = torch.rand((T, R, n_pad), generator=gen, device=m0.device)
    args = (eng.J_rows, eng.J_diag, eng.h, m0, phi0, None, beta, beta_spin,
            mask)
    k = sc.sequential_sweeps(*args, num_sweeps=T, record_m=True,
                             uniforms=u, nbrs=eng.sweep_nbrs)
    torch.cuda.synchronize()
    if plain_sweeps is None:
        p = run_sweeps(*args, num_sweeps=T, within_block="sequential",
                       record_m=True, uniforms=u)
    tw = _seq_twin(torch, eng, m0, phi0, beta, beta_spin, mask, T, u)
    check(_bit_equal(k, tw), f"{tag}: kernel != its association twin")
    check(torch.equal(k.M[-1], k.m), f"{tag}: M[-1] is not the last state")
    P, n_buf = sc.sequential_launch(1, R, n_pad, B, sc._num_sms(DEVICE))
    res = {"n_pad": n_pad, "R": R, "sweeps": T, "block_size": B,
           "beta_spin": list(torch.as_tensor(beta_spin).shape),
           "mask_frozen": int((~mask).sum()),
           "blocks_per_sweep": eng.blocked.num_blocks,
           "entries": int(eng.sweep_nbrs.src.shape[0]),
           "replicas_per_cta": P, "tile_buffers": n_buf,
           "bit_equal_association_twin": True}
    res["flipped_spins"] = int((k.m != m0).sum())
    err = 0.0
    if pm:
        check(_bit_equal(k, p), f"{tag}: kernel != run_sweeps bit for bit")
        res["bit_equal_run_sweeps"] = True
    else:
        if plain_sweeps is not None:
            Tp = res["run_sweeps_sweeps"] = plain_sweeps
            args = args[:6] + (beta[:Tp],) + args[7:]
            k = sc.sequential_sweeps(*args, num_sweeps=Tp, record_m=True,
                                     uniforms=u[:Tp], nbrs=eng.sweep_nbrs)
            p = run_sweeps(*args, num_sweeps=Tp, within_block="sequential",
                           record_m=True, uniforms=u[:Tp])
        res["vs_run_sweeps"], err = _compare(torch, tag, k, p, eng.J_full,
                                             eng.h, m0, mask)
        same = ~(k.m != p.m).any(dim=1)
        check(torch.equal(k.M[:, same], p.M[:, same]),
              f"{tag}: recorded states differ from run_sweeps'")
    return res, err


def _sk_ensemble(torch, count, pm, seed=0):
    """EnsemblePT on `count` SK-1000 instances x 64 replicas at the phase's
    ladder (+-J when `pm`, else Gaussian `random_sk`), its state after
    init and the first round's fields and slot betas [I, R, 1]."""
    from nmc_tpu_torch.io.generators import random_sk
    from nmc_tpu_torch.parallel import EnsembleConfig, EnsemblePT
    probs = [_sk_pm(SK_N, s) if pm else random_sk(SK_N, seed=s)
             for s in range(seed, seed + count)]
    ens = EnsemblePT(probs, np.geomspace(0.1, 3.0, SK_REPLICAS),
                     EnsembleConfig(num_replicas=SK_REPLICAS), device=DEVICE)
    check(ens.sweep_kernel == "sequential_sweeps_batched",
          f"EnsemblePT route {ens.sweep_kernel}")
    st = ens.init_state(torch.Generator(device=DEVICE).manual_seed(seed))
    phi = ens.h[:, None, :] + torch.bmm(st.m, ens.J_full)
    return probs, ens, st, phi, ens.beta_list[st.slot_to_beta][..., None]


def _hold_batched(torch):
    """`sequential_sweeps_batched` over 4 +-J SK-1000 instances x 64
    (EnsemblePT's layout and slot betas, 8 sweeps): with injected uniforms
    bit for bit against its association twin over the union layout and
    against run_sweeps per instance; with its own Philox draws (seed words
    [4, 2]) bit for bit against per-instance `sequential_sweeps` launches
    with seed=seeds[i] over each instance's own layout."""
    from nmc_tpu_torch.ops import sweeps_cuda as sc
    from nmc_tpu_torch.ops.sweeps import SweepResult, run_sweeps
    _, ens, st, phi, beta_slot = _sk_ensemble(torch, 4, True)
    I, R, n_pad = st.m.shape
    T = 8
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    u = torch.rand((T, I, R, n_pad), generator=gen, device=DEVICE)
    ones = torch.ones(T, device=DEVICE)
    args = (ens.J_rows, ens.J_diag, ens.h, st.m, phi)
    k = sc.sequential_sweeps_batched(*args, None, ones, beta_slot, ens.active,
                                     num_sweeps=T, uniforms=u,
                                     nbrs=ens.sweep_nbrs, record_m=True)
    torch.cuda.synchronize()
    tw = sc.sequential_sweeps_reference(
        ens.sweep_nbrs, ens.J_diag, ens.h, st.m, phi, None, ones,
        beta_slot[..., 0], ens.active, num_sweeps=T, uniforms=u,
        record_m=True)
    check(_bit_equal(k, tw), "batched: kernel != its association twin")
    act = ens.active.expand(R, n_pad)
    for i in range(I):
        p = run_sweeps(ens.J_rows[i], ens.J_diag[i], ens.h[i], st.m[i],
                       phi[i], None, ones, beta_slot[i], act, num_sweeps=T,
                       within_block="sequential", record_m=True,
                       uniforms=u[:, i].contiguous())
        check(_bit_equal(SweepResult(*(x[i] for x in k)), p),
              f"batched: instance {i} != run_sweeps bit for bit")
    seeds = sc.draw_seeds(gen, (I,)).to(DEVICE)
    kb = sc.sequential_sweeps_batched(*args, None, ones, beta_slot,
                                      ens.active, num_sweeps=T, seeds=seeds,
                                      nbrs=ens.sweep_nbrs)
    for i in range(I):
        one = sc.sequential_sweeps(
            ens.J_rows[i], ens.J_diag[i], ens.h[i], st.m[i], phi[i], None,
            ones, beta_slot[i], act, num_sweeps=T, seed=seeds[i],
            nbrs=sc.sequential_neighbors(ens.J_rows[i]))
        check(_bit_equal(one, type(one)(*(None if x is None else x[i]
                                           for x in kb))),
              f"batched: instance {i} != its own launch with its seed words")
    return {"instances": I, "R": R, "n_pad": n_pad, "sweeps": T,
            "bit_equal_association_twin": True,
            "bit_equal_run_sweeps": True,
            "bit_equal_per_instance_philox": True,
            "flipped_spins": int((k.m != st.m).sum())}


# The in-block chain alone, one spin a round (kLookahead 1, no runs) and no
# phi update: its ms over T sweeps of n_pad spins is the chain floor, and that
# over T * n_pad the measured step time (chip_smoke.py --sequential-ablation
# has it beside the other variants)
_SEQ_SPIN_CHAIN = ("constexpr int kLookahead = 128;",
                   "constexpr int kLookahead = 1;")
# a round keeps its first flip only (no runs of flips on sparse blocks)
_SEQ_NO_RUNS = ("constexpr bool kRuns = true;",
                "constexpr bool kRuns = false;")
_SEQ_NO_PHI_UPDATE = (
    "      update_phi<kS, kP>(a.nb, w, b, dm, flipped + q * B, phi, n_pad);\n",
    "")
_SEQ_NO_BOUNDS = ("constexpr bool kBounds = true;",
                  "constexpr bool kBounds = false;")
# the parts of a block around the chain, each taken out of the chain alone
_SEQ_NO_ENERGY = ("        acc += (float)m_w[j] * (phi_w[j] + h[j]);\n", "")
_SEQ_NO_TILE_COPY = [
    ("if (a.n_buf == 2 && more) copy_tile", "if (false) copy_tile"),
    ("if (a.n_buf == 1 && more) copy_tile", "if (false) copy_tile")]
SEQ_ABLATIONS = {"as_is": [], "spin_chain": [_SEQ_SPIN_CHAIN, _SEQ_NO_RUNS],
                 "no_runs": [_SEQ_NO_RUNS],
                 "no_bounds": [_SEQ_NO_BOUNDS],
                 "no_phi_update": [_SEQ_NO_PHI_UPDATE],
                 "chain_floor": [_SEQ_SPIN_CHAIN, _SEQ_NO_PHI_UPDATE,
                                 _SEQ_NO_RUNS],
                 "chain_no_energy": [_SEQ_NO_PHI_UPDATE, _SEQ_NO_ENERGY],
                 "chain_no_tile_copy": [_SEQ_NO_PHI_UPDATE,
                                        *_SEQ_NO_TILE_COPY],
                 "chain_no_bounds": [_SEQ_NO_PHI_UPDATE, _SEQ_NO_BOUNDS]}
_SEQ_SAME_ARITHMETIC = ("spin_chain", "no_runs", "no_bounds")


def _seq_flips(m0, M):
    """Spin flips of a recorded launch: changes from m0 and between
    consecutive recorded states (M [..., T, R, n_pad])."""
    first = (M.select(-3, 0) != m0).sum()
    return int(first + (M.narrow(-3, 1, M.shape[-3] - 1)
                        != M.narrow(-3, 0, M.shape[-3] - 1)).sum())


def _seq_bound(torch, nbrs, J_diag, R, T, n_pad, N, flips, degree):
    """The least time the card could take for a sequential launch: per
    attempt a Philox and the draw (OPS_PER_ATTEMPT), per flip one FMA per
    coupling, per sweep the energy, at the f32 rate; or its inputs (the
    layout, the tiles, states and fields, h, the mask) and outputs once at
    the HBM rate. (ops, bytes, ms, bound_by)."""
    I = J_diag.shape[0]
    attempts = I * R * T * N
    ops = (attempts * OPS_PER_ATTEMPT + flips * 2 * degree
           + 3 * I * R * T * n_pad)
    layout = sum(t.numel() * t.element_size() for t in nbrs
                 if isinstance(t, torch.Tensor))
    nbytes = (layout + J_diag.numel() * 4 + 4 * I * n_pad + n_pad + 4 * T
              + 4 * I * R + 2 * 4 * I * R * n_pad
              + 3 * 4 * I * R * n_pad + 4 * I * R + 4 * I * T * R)
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_HBM_BYTES
    return (ops, nbytes, 1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def _chain_floor(torch, cases, lib):
    """The chain floor of each (tag, engine, R, T) case: `lib`, the
    `chain_floor` variant (the in-block chain one spin a round, no phi
    update; a patched copy of csrc/sequential_sweeps.cu built by
    `phase_build`), timed at the case's shape from a burnt-in state at
    beta 2 (CUDA events, best of 3): its ms, and that ms over T x n_pad as
    the step time."""
    from nmc_tpu_torch.ops import _build
    from nmc_tpu_torch.ops import sweeps_cuda as sc
    out = {}
    for tag, eng, R, T in cases:
        gen = torch.Generator(device=DEVICE).manual_seed(2)
        m0 = eng.init_states(gen, R)
        betas = torch.full((T,), 2.0, device=DEVICE)
        one = torch.ones((), device=DEVICE)

        def call(m, phi):
            return sc.sequential_sweeps(
                eng.J_rows, eng.J_diag, eng.h, m, phi, gen, betas, one,
                eng.active[None], num_sweeps=T, nbrs=eng.sweep_nbrs)
        st = call(m0, eng.fields(m0))               # burn-in on the kernel
        saved = _build._LIBS.get("sequential_sweeps")
        _build._LIBS["sequential_sweeps"] = lib
        try:
            call(st.m, st.phi)
            ms = min(_event_ms(torch, lambda: call(st.m, st.phi))[0]
                     for _ in range(3))
        finally:
            _build._LIBS["sequential_sweeps"] = saved
        out[tag] = {"R": R, "sweeps": T, "n_pad": eng.n_pad,
                    "chain_floor_ms": ms,
                    "step_us": 1e3 * ms / (T * eng.n_pad)}
    return out


def phase_sequential_kernel(floor_lib):
    """The sequential route (`sequential_sweeps`, csrc/sequential_sweeps.cu)
    against its association twin `sequential_sweeps_reference` (bit for
    bit) and its plain twin `run_sweeps(within_block="sequential")` with
    injected uniforms (`_hold_sequential`): 8 sweeps from beta 0.3 to 3 on
    +-J SK-1000 (R = 64; bit for bit) and Gaussian chimera 8x8 (R = 256;
    `_compare`'s tolerance); ShardedNPT's C-phase launch on +-J SK-1000
    (R = 32, 64 sweeps, per-spin heated beta_spin and the NMC slots'
    masks) bit for bit; the contrived ICM round's launch (R = 320, 576
    sweeps, per-slot beta); +-J SK-1000 in blocks of 256 (R = 16, 8 sweeps;
    the kernel runs sub-blocks of 128) bit for bit against both. The
    batched entry (`_hold_batched`; at EnsemblePT's own launch in
    `phase_ensemble_pt`). Its own Philox draws against the Boltzmann law of
    a 4-cycle; ms per call of the route and the plain version beside the
    bound and the chain floor at EnsemblePT's launch (Gaussian SK-1000, R
    = 64; 16 sweeps) and on the chimera case (R = 256, 16 sweeps).
    `floor_lib` is the chain-floor variant `phase_build` built."""
    import torch
    from nmc_tpu_torch.io.generators import random_sk
    from nmc_tpu_torch.ops import sweeps_cuda as sc
    from nmc_tpu_torch.ops.engine import SweepEngine
    out = {"phase": "sequential_kernel"}
    max_err = 0.0
    timing = {}
    for tag, prob, R, pm in _sequential_cases():
        eng = SweepEngine(prob, device=DEVICE)
        gen = torch.Generator(device=DEVICE).manual_seed(3)
        m0 = eng.init_states(gen, R)
        out[tag], err = _hold_sequential(
            torch, tag, eng, m0, torch.linspace(0.3, 3.0, 8, device=DEVICE),
            torch.ones((), device=DEVICE), eng.active.expand(R, eng.n_pad),
            pm, gen)
        max_err = max(max_err, err)
        timing[tag] = (prob, eng)
    for tag, launch, pm in (("sharded_npt_c_phase", _sharded_npt_c_phase,
                             True),
                            ("icm_round_contrived", _icm_round_contrived,
                             False)):
        eng, m0, beta_spin, mask, T = launch(torch)
        out[tag], err = _hold_sequential(
            torch, tag, eng, m0, torch.ones((T,), device=DEVICE), beta_spin,
            mask, pm, torch.Generator(device=DEVICE).manual_seed(6),
            plain_sweeps=None if pm else 8)
        max_err = max(max_err, err)
    eng = SweepEngine(_sk_pm(SK_N, 0), block_size=256, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    m0 = eng.init_states(gen, 16)
    out["sk1000_pm_blocks256"], _ = _hold_sequential(
        torch, "sk1000_pm_blocks256", eng, m0,
        torch.linspace(0.3, 3.0, 8, device=DEVICE),
        torch.ones((), device=DEVICE), eng.active.expand(16, eng.n_pad),
        True, gen)
    out["batched"] = _hold_batched(torch)

    def run(eng, m, gen, beta, sweeps):
        return sc.sequential_sweeps(
            eng.J_rows, eng.J_diag, eng.h, m, eng.fields(m), gen,
            torch.full((sweeps,), beta, device=DEVICE),
            torch.ones((), device=DEVICE), eng.active[None],
            num_sweeps=sweeps).m
    tv = _boltzmann_tv(torch, run)
    check(tv < 0.05, f"sequential_sweeps Philox TV {tv} >= 0.05")
    out["boltzmann_tv"] = tv
    prob = random_sk(SK_N, seed=0)
    sk = SweepEngine(prob, device=DEVICE)
    tp = _throughput_one(torch, "sequential_sweeps", prob, sk, *SEQ_SHAPE, 1)
    cprob, chim = timing["chimera512_gauss"]
    tp_chim = _throughput_one(torch, "sequential_sweeps", cprob, chim, 256,
                              16, 1)
    floor = _chain_floor(torch, (("sk1000", sk, *SEQ_SHAPE),
                                 ("chimera512", chim, 256, 16)), floor_lib)
    tp["chain_floor"], tp_chim["chain_floor"] = floor["sk1000"], \
        floor["chimera512"]
    out["throughput_sk1000"], out["throughput_chimera512"] = tp, tp_chim
    emit(out)
    return max_err, tp


def phase_compat():
    """The reference-compatible shims on the card on chimera_graph(4, 4)
    (128 spins, the reference's chimera128 size), uncoloured (the shims'
    layout), at reduced sweeps: NMC.run, APT_preprocessor.run, NPT.run on
    its ladder and APT_ICM.run, each through the sequential route and no
    other kernel; shapes, seconds, launches, and the PNG files written or
    warned about (the card's machine may lack matplotlib)."""
    import os
    import tempfile
    import warnings
    from nmc_tpu_torch.compat import APT_ICM, NMC, NPT, APT_preprocessor
    from nmc_tpu_torch.io.generators import chimera_graph
    prob = chimera_graph(4, 4, seed=7, pm=False)
    n = prob.n
    out = {"phase": "compat", "n": n}
    total = 0
    cwd = os.getcwd()

    def timed(tag, fn, pngs):
        nonlocal total
        reset_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            result = fn()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        check(counts["sequential_sweeps"] > 0
              and all(v == 0 for k, v in counts.items()
                      if k != "sequential_sweeps"),
              f"compat {tag}: launches {counts}")
        total += counts["sequential_sweeps"]
        warned = [str(w.message) for w in caught
                  if "not written" in str(w.message)]
        written = [f for f in pngs if os.path.exists(f)]
        check(len(written) == len(pngs) or len(warned) == 1,
              f"compat {tag}: PNGs {written}, warnings {warned}")
        out[tag] = {"seconds": seconds,
                    "launches": counts["sequential_sweeps"],
                    "pngs_written": written, "warned": warned}
        return result

    with tempfile.TemporaryDirectory(prefix="chip_smoke_compat_") as tmp:
        os.chdir(tmp)
        try:
            nmc = NMC(prob.J, prob.h, device=DEVICE).seed(0)
            M, e, e_min = timed("nmc", lambda: nmc.run(
                num_sweeps_initial=1000, num_sweeps_per_NMC_phase=500,
                num_NMC_cycles=2, global_beta=3.0, lambda_start=3.0,
                max_iterations=200, tolerance=1e-8),
                ["NMC_spins.png", "NMC_energy.png"])
            check(M.shape == (n, 3000) and e.shape == (3000,)
                  and np.isfinite(e).all() and e_min == e.min(),
                  f"NMC.run shapes {M.shape}, {e.shape}")
            check(abs(float(prob.normalized()[0].energy(M[:, int(np.argmin(
                e))])) - e_min) <= 1e-3, "NMC.run: energy off its state")
            out["nmc"]["shapes"] = [list(M.shape), list(e.shape)]
            out["nmc"]["min_energy"] = e_min
            apt = APT_preprocessor(prob.J, prob.h, device=DEVICE).seed(1)
            beta, sigma = timed("apt_preprocessor", lambda: apt.run(
                num_sweeps_MCMC=500, num_sweeps_read=250, num_rng=64,
                alpha=1.5, beta_max=5.0), ["beta_sigma.png"])
            check(len(beta) >= 3 and np.all(np.diff(beta) > 0)
                  and os.path.exists("beta_list_python.npy"),
                  f"APT ladder {beta}")
            out["apt_preprocessor"]["ladder"] = beta
            R = min(len(beta), 8)
            npt = NPT(prob.J, prob.h, device=DEVICE).seed(2)
            M, E = timed("npt", lambda: npt.run(
                beta, R, [False] * (R - 2) + [True] * 2,
                num_sweeps_MCMC=2000, num_sweeps_read=1000,
                num_swap_attempts=10, num_cycles=1, lambda_start=3.0,
                max_iterations=200, tolerance=1e-8), ["NPT_energy.png"])
            check(M.shape == (R * n, 200) and E.shape == (R,)
                  and np.isfinite(E).all(), f"NPT.run shapes {M.shape}")
            out["npt"]["shapes"] = [list(M.shape), list(E.shape)]
            norm = np.abs(prob.J).max()
            icm = APT_ICM(prob.J / norm, prob.h / norm, device=DEVICE).seed(3)
            M, E = timed("apt_icm", lambda: icm.run(
                beta, R, num_sweeps_MCMC=2000, num_sweeps_read=1000,
                num_swap_attempts=10), ["APT_ICM_energy..png"])
            check(M.shape == (n * R, 2000) and E.shape == (R,)
                  and np.isfinite(E).all(), f"APT_ICM.run shapes {M.shape}")
            out["apt_icm"]["shapes"] = [list(M.shape), list(E.shape)]
        finally:
            os.chdir(cwd)
    emit(out)
    return total


def phase_ensemble_pt():
    """EnsemblePT on BASELINE config 5 on one card: 100 SK-1000 instances x
    64 replicas (J 0.42 GB in f32), a geometric ladder from 0.1 to 3, 32
    sweeps a round through the batched sequential route (one launch a
    round for every instance), one round to warm up and then 2 timed;
    seconds per round, launches, 2 more rounds with a `timings` dict for
    their fields / round / swaps split, and each best energy against the f64
    energy of its best state; then one round's launch alone (CUDA events,
    its Philox draws) beside its bound, and the same launch on injected
    uniforms held bit for bit against its plain twin
    `sequential_sweeps_reference` (timed too). Returns (launches, the
    kernels line's figures of `sequential_sweeps_batched`)."""
    import torch
    from nmc_tpu_torch.io.generators import random_sk
    from nmc_tpu_torch.ops import sweeps_cuda as sc
    from nmc_tpu_torch.parallel import EnsembleConfig, EnsemblePT
    t0 = time.perf_counter()
    probs = [random_sk(SK_N, seed=s) for s in range(SK_INSTANCES)]
    cfg = EnsembleConfig(num_replicas=SK_REPLICAS)
    ens = EnsemblePT(probs, np.geomspace(0.1, 3.0, SK_REPLICAS), cfg,
                     device=DEVICE)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    check(ens.sweep_kernel == "sequential_sweeps_batched", "EnsemblePT route")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    state = ens.init_state(gen)
    reset_counts()
    t0 = time.perf_counter()
    state = ens.run(state, 1)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    rounds = 2
    t0 = time.perf_counter()
    state = ens.run(state, rounds)
    torch.cuda.synchronize()
    per_round = (time.perf_counter() - t0) / rounds
    launches = read_counts()
    check_swaps(launches, rounds + 1, "EnsemblePT")
    check(launches["sequential_sweeps_batched"] == rounds + 1
          and not any(others(launches, "sequential_sweeps_batched",
                             "label_swaps").values()),
          f"EnsemblePT launches {launches}")
    # the same rounds again with a `timings` dict: their stage split
    timings = {}
    for _ in range(rounds):
        state = ens.round(state, timings=timings)
    ens.flush()
    check(set(timings) == {"fields", "round", "swaps", "rounds", "host_s",
                           "host_syncs"} and timings["rounds"] == rounds,
          f"EnsemblePT timings {timings}")
    best_m, best_e = ens.best_states(state), ens.best_energies(state)
    check(best_m.shape == (SK_INSTANCES, SK_N) and np.isfinite(best_e).all()
          and np.isin(best_m, [-1.0, 1.0]).all(), "EnsemblePT bests")
    e64 = np.array([p.energy(m) for p, m in zip(probs, best_m)])
    err = float(np.abs(e64 - best_e).max())
    check(err <= 1e-3, f"best energies off their f64 energies by {err}")
    perms = state.beta_to_slot.sort(dim=1).values.cpu().numpy()
    check((perms == np.arange(SK_REPLICAS)).all(), "label maps not perms")
    # one round's sweeps alone, at the state and slot betas the rounds
    # reached; flips from a recorded launch for the bound
    T = cfg.sweeps_per_round
    phi = ens.h[:, None, :] + torch.bmm(state.m, ens.J_full)
    beta_slot = ens.beta_list[state.slot_to_beta][..., None]
    ones = torch.ones(T, device=DEVICE)

    def launch(record=False):
        return sc.sequential_sweeps_batched(
            ens.J_rows, ens.J_diag, ens.h, state.m, phi, gen, ones,
            beta_slot, ens.active, num_sweeps=T, nbrs=ens.sweep_nbrs,
            record_m=record)
    launch()
    launch_ms = min(_event_ms(torch, launch)[0] for _ in range(3))
    flips = _seq_flips(state.m, launch(record=True).M)
    # the launch on injected uniforms against its plain twin, at this
    # launch's P (replicas per CTA) and tile buffers
    u = torch.rand((T, SK_INSTANCES, SK_REPLICAS, ens.n_pad),
                   generator=torch.Generator(device=DEVICE).manual_seed(8),
                   device=DEVICE)
    k = sc.sequential_sweeps_batched(
        ens.J_rows, ens.J_diag, ens.h, state.m, phi, None, ones, beta_slot,
        ens.active, num_sweeps=T, nbrs=ens.sweep_nbrs, uniforms=u)
    plain_ms, tw = _event_ms(torch, lambda: sc.sequential_sweeps_reference(
        ens.sweep_nbrs, ens.J_diag, ens.h, state.m, phi, None, ones,
        beta_slot[..., 0], ens.active, num_sweeps=T, uniforms=u))
    del u
    twin_err = max(float((x - y).abs().max()) for x, y in zip(k, tw)
                   if x is not None)
    check(_bit_equal(k, tw) and twin_err == 0.0,
          f"EnsemblePT launch != its association twin ({twin_err})")
    degree = float(np.mean([np.count_nonzero(p.J) / SK_N for p in probs]))
    ops, nbytes, bound_ms, bound_by = _seq_bound(
        torch, ens.sweep_nbrs, ens.J_diag, SK_REPLICAS, T, ens.n_pad, SK_N,
        flips, degree)
    P, n_buf = sc.sequential_launch(SK_INSTANCES, SK_REPLICAS, ens.n_pad,
                                    cfg.block_size, sc._num_sms(DEVICE))
    emit({"phase": "ensemble_pt", "instances": SK_INSTANCES, "n": SK_N,
          "n_pad": ens.n_pad, "replicas": SK_REPLICAS,
          "sweeps_per_round": T, "setup_seconds": setup,
          "warmup_round_seconds": warm, "seconds_per_round": per_round,
          "split_seconds_per_round": _per_round(timings),
          "launches": launches["sequential_sweeps_batched"],
          "launch_ms": launch_ms, "launch_plain_twin_ms": plain_ms,
          "twin_bit_equal": True, "twin_max_abs_err": twin_err,
          "twin_flipped_spins": int((k.m != state.m).sum()),
          "launch_bound_ms": bound_ms,
          "launch_bound_by": bound_by, "launch_bound_ops": ops,
          "launch_bound_bytes": nbytes,
          "flips_per_attempt": flips / (SK_INSTANCES * SK_REPLICAS * T
                                        * SK_N),
          "replicas_per_cta": P, "tile_buffers": n_buf,
          "J_bytes": int(ens.J_rows.numel() * 4),
          "layout_bytes": int(sum(
              t.numel() * t.element_size() for t in ens.sweep_nbrs
              if isinstance(t, torch.Tensor))),
          "best_energy_mean": float(best_e.mean()),
          "best_vs_f64_max_abs_err": err})
    return launches["sequential_sweeps_batched"], {
        "kernel_ms_per_call": launch_ms, "plain_ms_per_call": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": twin_err}


# The label swaps' shapes, I ladders x R labels x pairs: the benchmark
# cells' (the two chimera2048_x20 cells share one), then edge cases (one
# pair, more pairs than fit, lanes holding 2 and 4 pairs, one ladder of 127
# pairs); the last flag marks a cell's shape, which is also timed.
SWAP_SHAPES = {"chimera2048_x20": (20, 32, 8, True),
               "chimera2048_icm_x20": (200, 32, 8, True),
               "chimera5408_sharded": (1, 64, 16, True),
               "sk1000_x100": (100, 64, 4, True),
               "two_labels": (7, 2, 2, False),
               "more_pairs_than_fit": (9, 8, 6, False),
               "lanes_hold_two": (13, 40, 12, False),
               "lanes_hold_four": (5, 100, 40, False),
               "long_ladder": (3, 128, 60, False)}


def phase_label_swaps():
    """The label-swap kernel (`csrc/label_swaps.cu`) against its plain twin
    `label_swap_reference` run on the card, at each of SWAP_SHAPES with
    injected draws (spread, equal, overflowing and infinite energies) and
    with a generator's draws (the twin fed the same seed's draws in the
    wrapper's order), every output element for element and one launch a
    call; then at each cell's shape, in turns (twin, kernel, kernel, twin),
    ms a call by CUDA events: the wrapper's calls back to back (the host's
    pace), the twin (the torch stage less its host read; its enqueue paces
    it), and the stage as it ran before the kernel (the twin after a
    constant copied from host memory, which waits for the card); and the
    kernel's own device ms (torch.profiler, 50 calls), beside its bytes at
    3.35 TB/s. Returns
    (launches, the kernels line's figures at the chimera2048_x20 shape, with
    the largest difference of an output element between kernel and twin)."""
    import torch
    from nmc_tpu_torch.parallel import swaps as ts
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(21)

    def case(I, R, num_pairs, kind):
        b2s = torch.argsort(torch.rand((I, R), generator=gen, device=dev),
                            dim=1)
        beta = torch.logspace(-0.6, 1.5, R, device=dev)
        e = torch.randn((I, R), generator=gen, device=dev)
        e = {"spread": e * 3.0, "equal": e * 0.0 - 7.5, "huge": e * 1e30,
             "inf": torch.where(e > 0.6, float("inf"), e)}[kind]
        g = ts._gumbel((I, num_pairs, R - 1), gen, torch.float32, dev)
        u = torch.rand((I, num_pairs), generator=gen, device=dev)
        return b2s, beta, e, g, u

    def diff(a, b):
        """The largest difference of an output element (dtypes must agree);
        records it for the kernels line."""
        check(all(x.dtype == y.dtype for x, y in zip(a, b)),
              "label_swaps: kernel and twin dtypes differ")
        d = max(int((x.long() - y.long()).abs().max()) for x, y in zip(a, b))
        worst[0] = max(worst[0], d)
        return d

    torch.cuda.synchronize()
    reset_counts()
    calls, out, cell, worst = 0, {}, None, [0]
    for name, (I, R, num_pairs, timed) in SWAP_SHAPES.items():
        r = {"I": I, "R": R, "num_pairs": num_pairs}
        for kind in ("spread", "equal", "huge", "inf"):
            b2s, beta, e, g, u = case(I, R, num_pairs, kind)
            k = ts.metropolis_label_swap(b2s, beta, e, num_pairs=num_pairs,
                                         gumbels=g, uniforms=u)
            calls += 1
            check(diff(k, ts.label_swap_reference(b2s, beta, e, g, u)) == 0,
                  f"label_swaps {name} {kind}: kernel != twin")
            r[f"accepted_{kind}"] = int(k.accepted.sum())
        seeded = torch.Generator(device=dev).manual_seed(5)
        twin_gen = torch.Generator(device=dev).manual_seed(5)
        k = ts.metropolis_label_swap(b2s.int(), beta, e, num_pairs=num_pairs,
                                     generator=seeded)
        calls += 1
        g = ts._gumbel((I, num_pairs, R - 1), twin_gen, torch.float32, dev)
        u2 = torch.rand((I, num_pairs), generator=twin_gen, device=dev)
        twin = ts.label_swap_reference(b2s.int(), beta, e, g, u2)
        check(diff(k, twin) == 0,
              f"label_swaps {name}: kernel != twin on generator draws")
        check(read_counts()["label_swaps"] == calls,
              f"label_swaps launched {read_counts()['label_swaps']} times "
              f"for {calls} calls")
        if timed:
            b2s, beta, e, g, u = case(I, R, num_pairs, "spread")

            def kernel():
                return ts.metropolis_label_swap(
                    b2s, beta, e, num_pairs=num_pairs, gumbels=g, uniforms=u)

            def twin():
                return ts.label_swap_reference(b2s, beta, e, g, u)

            def with_read():
                torch.tensor(float("-inf"), device=dev)
                return twin()

            def per_call(fn, n):
                return _event_ms(torch, lambda: [fn() for _ in range(n)])[0] / n

            for fn in (kernel, twin, with_read):
                fn()
            times = {"twin": [per_call(twin, 50)],
                     "kernel": [per_call(kernel, 500), per_call(kernel, 500)]}
            times["twin"].append(per_call(twin, 50))
            times["with_read"] = [per_call(with_read, 50)]
            # the kernel's own device time (back to back, the calls above
            # run at the host's pace)
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(50):
                    kernel()
                torch.cuda.synchronize()
            ev = [x for x in prof.key_averages()
                  if "label_swaps_kernel" in x.key]
            device_ms = (sum(x.device_time_total for x in ev) / 1e3
                         / max(1, sum(x.count for x in ev)))
            calls += 1 + 1000 + 50
            nbytes = (I * num_pairs * (R - 1) * 4 + I * num_pairs * 4
                      + I * R * (4 + 8) + R * 4
                      + I * R * 16 + I * num_pairs * 9)
            r.update({"kernel_ms": device_ms,
                      "kernel_calls_profiled": sum(x.count for x in ev),
                      "call_ms": min(times["kernel"]),
                      "twin_ms": min(times["twin"]),
                      "stage_before_ms": times["with_read"][0],
                      "bytes": nbytes, "bound_ms": nbytes / 3.35e12 * 1e3})
            if name == "chimera2048_x20":
                cell = r
        out[name] = r
    counts = read_counts()
    check(counts["label_swaps"] == calls
          and not any(others(counts, "label_swaps").values()),
          f"label_swaps: launches {counts} for {calls} calls")
    emit({"phase": "label_swaps", "launches": calls,
          "max_abs_diff": worst[0], "shapes": out})
    return calls, {"kernel_ms_per_call": cell["kernel_ms"],
                   "plain_ms_per_call": cell["twin_ms"],
                   "bound_ms": cell["bound_ms"], "bound_by": "bytes",
                   "max_abs_err": float(worst[0])}


def phase_native_clusters():
    """Not a main path: the native union-find (`connected_components_masked`,
    g++-built cluster.cpp) against scipy's connected_components over the
    same CSR adjacency, on 3200 disagreement pairs at chimera 16x16 (2048
    spins; disagreement 5-60%): equal partitions, and both times."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    from nmc_tpu_torch import native
    from nmc_tpu_torch.io.generators import chimera_graph
    prob = chimera_graph(16, 16, seed=0)
    adj = native.CSRAdjacency(prob.J)
    native.load_cluster_library()
    rng = np.random.default_rng(0)
    n, pairs = prob.n, 3200
    s1 = np.where(rng.random((pairs, n)) < 0.5, -1.0, 1.0)
    frac = rng.uniform(0.05, 0.6, size=(pairs, 1))
    s2 = np.where(rng.random((pairs, n)) < frac, -s1, s1)
    active = (s1 * s2) < 0
    J_mask = csr_matrix((np.ones_like(adj.indices, dtype=np.int8),
                         adj.indices, adj.indptr), shape=(n, n))
    t0 = time.perf_counter()
    ours = [native.connected_components_masked(adj, a) for a in active]
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = []
    for a in active:
        diff = np.flatnonzero(a)
        ncomp, labels = connected_components(J_mask[diff][:, diff],
                                             directed=False)
        ref.append([diff[labels == c] for c in range(ncomp)])
    t_scipy = time.perf_counter() - t0
    comps = 0
    for a, b in zip(ours, ref):
        b = sorted(b, key=lambda c: c[0])
        check(len(a) == len(b) and all(np.array_equal(x, y)
                                       for x, y in zip(a, b)),
              "union-find partition differs from scipy's")
        comps += len(a)
    emit({"phase": "native_clusters", "n": n, "pairs": pairs,
          "components": comps, "native_seconds": t_native,
          "scipy_seconds": t_scipy, "native_ms_per_pair":
              1e3 * t_native / pairs, "scipy_ms_per_pair":
              1e3 * t_scipy / pairs})


# ---- the multi-GPU slice: offsets, the sharded CLI, ranks on one card -------

SHARDED_ROUNDS_C2048, SHARDED_ROUNDS_SK = 4, 2   # the CLI runs, cut in rounds
JAX_SHARDED_KEYS = {"min_energy", "rounds", "replicas", "devices",
                    "processes", "last_chunk_swap_accepts"}


def _halves_equal(torch, full, parts, dim):
    """Every output of `full` equal to its slices' outputs concatenated
    along `dim` (0 for replica rows of a sweep result; 0 or 1 for the round
    kernels' [I, R, ...]): the sweep results' energies are [T, R]."""
    ok = True
    for name, x in full._asdict().items():
        if x is None or name == "M":
            continue
        d = 1 if (name == "energies" and dim == 0) else dim
        ok &= torch.equal(x, torch.cat([getattr(p, name) for p in parts], d))
    return bool(ok)


def phase_sharded_offsets(c2048, r4096):
    """Not a main path: each of K1, K2, K3 and sequential_sweeps launched on
    the two replica halves of a ladder with their replica offsets and the
    whole launch's seed words (its own Philox draws), K4 / K5 on two
    replica halves and on two instance halves with their offsets, and
    sequential_sweeps_batched on two instance halves with their seed words
    (`_batched_halves`): every output equal, bit for bit, to the matching
    rows of the whole launch; and the second half launched without its
    offset (the batched entry: on the first half's seed words) differs
    (the offset, or the seed words, key the draws)."""
    import torch
    from nmc_tpu_torch.ops import round_cuda as rc
    from nmc_tpu_torch.ops.engine import SweepEngine
    from nmc_tpu_torch.ops.sweeps_cuda import draw_seeds
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    seq = SweepEngine(_sk_pm(SK_N, 0), device=DEVICE)
    check(seq.sweep_kernel == "sequential_sweeps", "sequential layout")
    out = {"phase": "sharded_offsets"}
    T = 16
    for name, eng, R in (("colored_sweeps", _flagship()[1], R_CHECK),
                         ("colored_sweeps_streamed", r4096[1], R_CHECK),
                         ("colored_sweeps_sparse", c2048[1], R_CHECK),
                         ("sequential_sweeps", seq, SK_REPLICAS)):
        check(eng.sweep_kernel == name, f"{name}: route {eng.sweep_kernel}")
        m0 = eng.init_states(gen, R)
        phi0 = eng.fields(m0)
        beta = torch.as_tensor(np.geomspace(0.3, 3.0, R), dtype=torch.float32,
                               device=DEVICE)
        seed = draw_seeds(gen).to(DEVICE)

        def run(lo, hi, off):
            return eng.run(m0[lo:hi].contiguous(), None, T, 1.0,
                           beta_replica=beta[lo:hi], blocked_input=True,
                           blocked_output=True, phi=phi0[lo:hi].contiguous(),
                           replica_offset=off, replicas_total=R, seed=seed)

        h = R // 2
        full, parts = run(0, R, 0), [run(0, h, 0), run(h, R, h)]
        torch.cuda.synchronize()
        unkeyed = run(h, R, 0)
        out[name] = {"R": R, "equal": _halves_equal(torch, full, parts, 0),
                     "unkeyed_half_differs": not torch.equal(
                         unkeyed.m, full.m[h:])}
        check(out[name]["equal"], f"{name}: offset halves != whole launch")
        check(out[name]["unkeyed_half_differs"],
              f"{name}: the offset changed no draw")
    for name, size in (("ensemble_round", 8), ("ensemble_round_sparse", 16)):
        _, ens, _ = _ensemble(size, 4)
        m0, cl, dn, beta, _ = _round_inputs(torch, ens, 11)
        I, R = m0.shape[:2]
        seed = draw_seeds(gen).to(DEVICE)
        nb = ens.round_nbrs
        kw = dict(num_cycles=3, sweeps_per_phase=8, seed=seed)

        def launch(i0, i1, r0, r1, off_i, off_r):
            sl = (slice(i0, i1), slice(r0, r1))
            args = (ens.h[i0:i1].contiguous(), ens.active,
                    m0[sl].contiguous(), cl[sl].contiguous(),
                    dn[sl].contiguous(), beta[sl].contiguous(), None)
            nbrs = nb._replace(w=nb.w[i0:i1].contiguous())
            shard = dict(replica_offset=off_r, replicas_total=R,
                         instance_offset=off_i, instances_total=I)
            if name == "ensemble_round_sparse":
                col_idx, J_tiles = ens._stream_tiles
                return rc.ensemble_round_sparse(
                    col_idx, J_tiles[i0:i1].contiguous(), *args, nbrs=nbrs,
                    **kw, **shard)
            return rc.ensemble_round(
                ens.J_full[i0:i1].contiguous(), *args, nbrs=nbrs,
                block_size=ens.blocked0.block_size, **kw, **shard)

        full = launch(0, I, 0, R, 0, 0)
        hr, hi = R // 2, I // 2
        by_r = [launch(0, I, 0, hr, 0, 0), launch(0, I, hr, R, 0, hr)]
        by_i = [launch(0, hi, 0, R, 0, 0), launch(hi, I, 0, R, hi, 0)]
        unkeyed = launch(hi, I, 0, R, 0, 0)
        torch.cuda.synchronize()
        out[name] = {"I": I, "R": R,
                     "replica_halves_equal": _halves_equal(torch, full,
                                                           by_r, 1),
                     "instance_halves_equal": _halves_equal(torch, full,
                                                            by_i, 0),
                     "unkeyed_half_differs": not torch.equal(
                         unkeyed.m, full.m[hi:])}
        check(out[name]["replica_halves_equal"]
              and out[name]["instance_halves_equal"],
              f"{name}: offset halves != whole launch: {out[name]}")
        check(out[name]["unkeyed_half_differs"],
              f"{name}: the instance offset changed no draw")
    out["sequential_sweeps_batched"] = _batched_halves(torch, gen)
    emit(out)


def _batched_halves(torch, gen):
    """`sequential_sweeps_batched` on 4 +-J SK-1000 instances x 32 (8
    sweeps, the whole launch's seed words [4, 2]) against its two instance
    halves launched with their rows of the seed words (the union layout's
    weights sliced): every output equal to the whole launch's rows, bit
    for bit; the second half on the first half's seed words differs."""
    from nmc_tpu_torch.ops import sweeps_cuda as sc
    _, ens, st, phi, beta_slot = _sk_ensemble(torch, 4, True)
    I, T, R = 4, 8, 32
    seeds = sc.draw_seeds(gen, (I,)).to(DEVICE)
    ones = torch.ones(T, device=DEVICE)

    def launch(i0, i1, keys):
        return sc.sequential_sweeps_batched(
            ens.J_rows[i0:i1], ens.J_diag[i0:i1], ens.h[i0:i1],
            st.m[i0:i1, :R].contiguous(), phi[i0:i1, :R].contiguous(), None,
            ones, beta_slot[i0:i1, :R], ens.active, num_sweeps=T,
            seeds=keys, nbrs=ens.sweep_nbrs._replace(
                w=ens.sweep_nbrs.w[i0:i1].contiguous()))
    full, h = launch(0, I, seeds), I // 2
    parts = [launch(0, h, seeds[:h]), launch(h, I, seeds[h:])]
    rekeyed = launch(h, I, seeds[:h])
    torch.cuda.synchronize()
    res = {"I": I, "R": R, "instance_halves_equal": all(
        torch.equal(x, torch.cat([getattr(p, f) for p in parts]))
        for f, x in full._asdict().items() if x is not None),
        "rekeyed_half_differs": not torch.equal(rekeyed.m, full.m[h:])}
    check(res["instance_halves_equal"],
          "sequential_sweeps_batched: instance halves != whole launch")
    check(res["rekeyed_half_differs"],
          "sequential_sweeps_batched: the seed words changed no draw")
    return res


def _sharded_cli(tag, argv, prob, seen, rounds):
    """The `sharded` CLI in process; checks its record against the f64
    energy of the engine's best state and returns (record, launches,
    seconds)."""
    rc_, rec, seconds, counts, _ = _cli(argv)
    seen["npt"].flush()
    check(rc_ in (None, 0) and rec is not None and set(rec) ==
          JAX_SHARDED_KEYS, f"sharded {tag}: record {rec}")
    check(rec["rounds"] == rounds and rec["processes"] == 1
          and rec["devices"] == 1, f"sharded {tag}: {rec}")
    npt, state = seen["npt"], seen["state"]
    e32, m = npt.best(state)
    e64 = float(prob.energy(m))
    check(abs(e64 - rec["min_energy"]) <= 1e-9 * max(1.0, abs(e64))
          and abs(e64 - e32) <= 1e-3 * max(1.0, abs(e64)),
          f"sharded {tag}: best {e32} vs f64 {e64} vs {rec['min_energy']}")
    return rec, counts, seconds, e32, e64


def phase_sharded_npt(card):
    """The slice's main path: `python -m nmc_tpu_torch sharded` in process
    on a real NCCL process group of world size 1 (the default group every
    later phase sees), at the CLI's defaults (32 replicas geomspace
    0.25-16, 64 sweeps a phase, 3 cycles, 8 swap pairs), cut in rounds
    only: chimera 16x16 with --coloring --nmc-coldest 4 through K5 (one
    launch a round over 1 x 32 slots), and SK-1000 uncoloured with
    --nmc-coldest 2 through sequential_sweeps (9 phases a round). Each
    record against the f64 energy of the best state, the launches, the
    seconds per round split into lbp / round / swaps (on chimera through
    `--metrics`, whose one `round_spans` record is checked), and one K5
    launch at that shape alone (CUDA events) beside its bound."""
    import tempfile
    import torch
    import torch.distributed as dist
    from nmc_tpu_torch.io.generators import chimera_graph, random_sk
    from nmc_tpu_torch.ops import round_cuda as rc
    from nmc_tpu_torch.parallel import distributed, sharded_pt
    from nmc_tpu_torch.parallel.dryrun import free_port
    check(distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0,
                                 backend="nccl"), "NCCL group")
    check(dist.get_backend() == "nccl" and distributed.world_size() == 1,
          f"backend {dist.get_backend()}")
    x = torch.ones(4, device=DEVICE)
    distributed.sum_(x, distributed.global_group())
    dist.all_reduce(x)          # a real NCCL collective at world 1
    check(torch.equal(x, torch.ones(4, device=DEVICE)), "NCCL all_reduce")
    seen = {}
    orig = sharded_pt.ShardedNPT.run_scanned

    def recording(self, state, num_rounds, timings=None, **kw):
        # the CLI's own dict under --metrics, else one of the phase's
        if timings is None:
            timings = seen.setdefault("timings", {})
        seen["timings"] = timings
        st, met = orig(self, state, num_rounds, timings=timings, **kw)
        seen.update(npt=self, state=st)
        return st, met

    out = {"phase": "sharded_npt", "card": card,
           "backend": dist.get_backend()}
    launches = {}
    sharded_pt.ShardedNPT.run_scanned = recording
    try:
        with tempfile.TemporaryDirectory() as tmp:
            c16 = chimera_graph(16, 16, seed=0)
            path = f"{tmp}/chimera16.txt"
            _write_chimera(path, c16)
            n = SHARDED_ROUNDS_C2048
            spans_path = f"{tmp}/spans.jsonl"
            rec, counts, secs, e32, e64 = _sharded_cli(
                "chimera16x16", ["sharded", "--instance", path, "--format",
                                 "chimera", "--coloring", "--nmc-coldest",
                                 "4", "--rounds", str(n), "--chunk-rounds",
                                 str(n), "--metrics", spans_path],
                c16.normalized()[0], seen, n)
            with open(spans_path) as f:
                logged = [json.loads(ln) for ln in f]
            check(len(logged) == 1 and logged[0]["kind"] == "round_spans"
                  and logged[0]["rank"] == 0 and logged[0]["rounds"] == n,
                  f"chimera16x16: --metrics record {logged}")
            npt, state = seen["npt"], seen["state"]
            steps = _steps(npt, npt.R_local)
            sweeps = n * npt.cfg.sweeps_per_phase * 3 * npt.cfg.num_cycles
            check(logged[0].get("round_steps") == sweeps
                  * steps["steps_per_sweep"]
                  and logged[0].get("round_blocks") == sweeps
                  * steps["blocks_per_sweep"],
                  f"chimera16x16: the record's round counters against "
                  f"{steps}")
            check_swaps(counts, n, "chimera16x16")
            check(npt.round_path == "K5" and npt.R_local == 32
                  and counts["ensemble_round_sparse"] == n
                  and sum(others(counts, "label_swaps").values()) == n,
                  f"chimera16x16: route {npt.round_path}, launches {counts}")
            k5 = _sharded_k5_alone(torch, rc, npt, state)
            out["chimera16x16"] = {
                "record": rec, "best_f32": e32, "best_f64": e64,
                "launches": counts, "seconds": secs,
                "round_spans_record": logged[0],
                "seconds_per_round": _per_round(seen.pop("timings")),
                "k5_alone": k5, **steps}
            out["chimera26x26_16_slots_k5_alone"] = _k5_c26_16_slots(torch,
                                                                     rc)
            launches["ensemble_round_sparse"] = n
            sk = random_sk(SK_N, seed=0)
            np.save(f"{tmp}/J.npy", sk.J)
            n = SHARDED_ROUNDS_SK
            rec, counts, secs, e32, e64 = _sharded_cli(
                "sk1000", ["sharded", "--J", f"{tmp}/J.npy", "--nmc-coldest",
                           "2", "--rounds", str(n), "--chunk-rounds", str(n)],
                sk.normalized()[0], seen, n)
            npt = seen["npt"]
            check_swaps(counts, n, "sk1000")
            check(npt.round_path == "phases"
                  and npt.engine.sweep_kernel == "sequential_sweeps"
                  and counts["sequential_sweeps"] == 9 * n
                  and sum(others(counts, "label_swaps").values()) == 9 * n,
                  f"sk1000: route {npt.engine.sweep_kernel}, {counts}")
            out["sk1000"] = {
                "record": rec, "best_f32": e32, "best_f64": e64,
                "launches": counts, "seconds": secs,
                "seconds_per_round": _per_round(seen.pop("timings"))}
            launches["sequential_sweeps"] = 9 * n
    finally:
        sharded_pt.ShardedNPT.run_scanned = orig
    emit(out)
    return launches


def _k5_c26_16_slots(torch, rc):
    """K5 at one card's launch of the four-card sharded run: chimera 26x26,
    16 slots of a 64-slot ladder (replica offset 16), one 576-sweep round
    with Philox, timed by CUDA events (median of 5 after a warm-up) at the
    CTA width the wrapper takes and at 256 threads, beside the bound of
    the launch's work (`_round_work`)."""
    from types import SimpleNamespace
    full = dict(num_cycles=3, sweeps_per_phase=64)
    ens, kw = _c26_16_slots()
    R = kw["replica_offset"]
    m0, cl, dn, beta, gen = _round_inputs(torch, ens, 7)
    kernel = _round_fns(ens)[0]
    kw.update(full)
    flips = torch.zeros((1, R), dtype=torch.int32, device=DEVICE)
    kernel(m0, cl, dn, beta, gen, flips=flips, **kw)

    def median_ms():
        return float(np.median([_event_ms(torch, lambda: kernel(
            m0, cl, dn, beta, gen, **kw))[0] for _ in range(5)]))

    out = {"n_pad": ens.n_pad, "ms": median_ms(), **_steps(ens, R)}
    with _round_width(rc, rc.ROUND_WIDTHS[0]):
        out["ms_at_256_threads"] = median_ms()
    attempts, ops, nbytes = _round_work(
        torch, ens, SimpleNamespace(m=m0, cl=cl, do_nmc_slot=dn), full,
        int(flips.sum()), 9 * 64)
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_HBM_BYTES
    out.update(attempts=attempts, bound_ms=1e3 * max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               share_of_bound=1e3 * max(t_ops, t_bytes) / out["ms"])
    return out


def _sharded_k5_alone(torch, rc, npt, state):
    """One K5 launch at the CLI run's shape (1 x 32 slots, its masks and
    betas), timed by CUDA events (median of 5 after a warm-up), beside the
    bound of the work of that launch (`_round_work`)."""
    from types import SimpleNamespace
    cfg = npt.cfg
    base = torch.where(state.do_nmc_slot, cfg.global_beta,
                       npt.beta_list[state.slot_to_beta]).contiguous()
    flips = torch.zeros((1, npt.R_local), dtype=torch.int32, device=DEVICE)
    kw = dict(num_cycles=cfg.num_cycles,
              sweeps_per_phase=cfg.sweeps_per_phase,
              temp_x_inv=1.0 / cfg.temp_x, nbrs=npt.round_nbrs)
    args = (*npt._stream_tiles, npt.h[None], npt.active, state.m[None],
            state.cl[None], state.do_nmc_slot[None], base[None])
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    rc.ensemble_round_sparse(*args, gen, flips=flips, **kw)
    times = [_event_ms(torch, lambda: rc.ensemble_round_sparse(
        *args, gen, **kw))[0] for _ in range(5)]
    fake = SimpleNamespace(m=state.m[None], cl=state.cl[None],
                           do_nmc_slot=state.do_nmc_slot[None])
    attempts, ops, nbytes = _round_work(
        torch, npt, fake, dict(num_cycles=cfg.num_cycles,
                               sweeps_per_phase=cfg.sweeps_per_phase),
        int(flips.sum()), cfg.sweeps_per_phase * 3 * cfg.num_cycles)
    bound = max(ops / PEAK_F32_OPS, nbytes / PEAK_HBM_BYTES) * 1e3
    return {"ms": float(np.median(times)), "bound_ms": bound,
            "bound_by": ("operations" if ops / PEAK_F32_OPS
                         >= nbytes / PEAK_HBM_BYTES else "bytes"),
            "attempts": attempts, "flips": int(flips.sum())}


def sharded_rank_suite(device, payload=None):
    """What each rank of `phase_sharded_ranks` runs (and the parent at
    world 1): `dryrun_multirank`, then on the current group ShardedNPT on
    chimera 16x16 (K5) and SK-1000 (sequential_sweeps) at the CLI's
    defaults, SpinShardedSweeper on ea_2d(64) (4096 spins, column blocks of
    64, 3 sweeps and one swap round), EnsembleNMC on the ensemble_512
    family (20 chimera 8x8, K4, 2 rounds), EnsembleICM on it (1 round) and
    EnsemblePT on 4 SK-1000 x 64 replicas (2 rounds). Returns the gathered
    results (numpy) and the seconds of each case."""
    import torch
    from nmc_tpu_torch.io.generators import chimera_graph, ea_2d, random_sk
    from nmc_tpu_torch.parallel import (EnsembleConfig, EnsemblePT,
                                        ShardedNPT, ShardedNPTConfig,
                                        SpinShardedConfig,
                                        SpinShardedSweeper, distributed)
    from nmc_tpu_torch.parallel.dryrun import (_ensemble_result, _np,
                                               _npt_result, dryrun_multirank)
    group = distributed.global_group()
    W = distributed.group_shape(group)[0]
    x = torch.ones(3, device=DEVICE)
    distributed.sum_(x, group)      # gloo over a CUDA tensor, when W > 1
    check(torch.equal(x, torch.full((3,), float(W), device=DEVICE)),
          f"all_reduce over {W} ranks")
    seconds, out = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0

    def gen(seed):
        return torch.Generator(device=DEVICE).manual_seed(seed)

    timed("dryrun", lambda: {"ok": bool(dryrun_multirank(device))})

    def npt(prob, nmc, coloring):
        R = 32
        cfg = ShardedNPTConfig(sweeps_per_phase=64, num_cycles=3,
                               num_swapping_pairs=R // 4, global_beta=2.5,
                               temp_x=TEMP_X, use_coloring=coloring)
        pt = ShardedNPT(prob.normalized()[0], np.geomspace(0.25, 16.0, R),
                        [False] * (R - nmc) + [True] * nmc, cfg,
                        group=group, device=DEVICE)
        st, met = pt.run_scanned(pt.init_state(gen(1)), 2)
        return {**_npt_result(pt, st, met), "route": pt.round_path}

    timed("sharded_npt_k5", lambda: npt(chimera_graph(16, 16, seed=0), 4,
                                         True))
    timed("sharded_npt_sk1000", lambda: npt(random_sk(SK_N, seed=0), 2,
                                             False))

    def spin():
        sw = SpinShardedSweeper(ea_2d(64, seed=0), SpinShardedConfig(
            block_size=64), group=group, device=DEVICE)
        st = sw.init_state(gen(2), 8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, e1 = sw.sweeps(st, 3, 1.0)
        torch.cuda.synchronize()
        # the per-block step (draw, owner's update, all_reduce, phi update)
        seconds["spin_block_step_ms"] = ((time.perf_counter() - t0) * 1e3
                                         / (3 * sw.nB_real))
        st, e2 = sw.swap_round(st, 2, np.geomspace(0.3, 3.0, 8),
                               num_swapping_pairs=2)
        return {"m": sw.states(st), "energies": _np(e2),
                "beta_to_slot": _np(st.beta_to_slot)}

    timed("spin_ea2d64", spin)

    def nmc():
        _, ens, _ = _ensemble(8, 20, group=group)
        check(ens.round_path == "K4", f"ensemble route {ens.round_path}")
        st = ens.run_scanned(ens.init_state(gen(3)), 2)
        return _ensemble_result(ens, st, ens.best(st))

    timed("ensemble_nmc_512", nmc)

    def icm():
        _, ens, _ = _icm_ensemble(8, 20, group=group)
        st = ens.run_scanned(ens.init_state(gen(4)), 1)
        return _ensemble_result(ens, st, ens.best(st))

    timed("ensemble_icm_512", icm)

    def pt():
        ens = EnsemblePT([random_sk(SK_N, seed=s) for s in range(4)],
                         np.geomspace(0.1, 3.0, SK_REPLICAS),
                         EnsembleConfig(num_replicas=SK_REPLICAS),
                         group=group, device=DEVICE)
        st = ens.run(ens.init_state(gen(5)), 2)
        return {"m": distributed.host_gather(st.m, group),
                "e_best": ens.best_energies(st),
                "m_best": ens.best_states(st)}

    timed("ensemble_pt_sk1000", pt)
    return {"results": out, "seconds": seconds, "world": W}


def _ranks_against_world1(ranks, world1, world):
    """Each case of `sharded_rank_suite` on every rank against the world-1
    run, field by field bit for bit: {case: equal}; fails unless every
    rank ran at `world` ranks and every case is equal."""
    equal = {case: all(
        set(r["results"][case]) == set(ref) and all(
            np.array_equal(np.asarray(r["results"][case][f]), np.asarray(v))
            for f, v in ref.items()) for r in ranks)
        for case, ref in world1["results"].items()}
    check(all(r["world"] == world for r in ranks), "rank world sizes")
    check(all(equal.values()), f"ranks differ from world 1: {equal}")
    return equal


def phase_sharded_ranks(card):
    """Not a main path: 2 ranks spawned on this one card (fresh
    interpreters, a gloo group over CUDA tensors, as NCCL refuses two
    ranks on one device), each running `sharded_rank_suite`; the parent
    runs it at world size 1 on the NCCL group of `phase_sharded_npt`.
    Every result of both ranks equal to world 1's, bit for bit."""
    from nmc_tpu_torch.parallel.dryrun import launch_ranks
    t0 = time.perf_counter()
    ranks = launch_ranks("chip_smoke:sharded_rank_suite", 2, backend="gloo",
                         device="cuda", payload={}, timeout=600, threads=2)
    ranks_seconds = time.perf_counter() - t0
    world1 = sharded_rank_suite("cuda", {})
    emit({"phase": "sharded_ranks", "card": card, "ranks": 2,
          "backend": "gloo",
          "launch_seconds": ranks_seconds,
          "rank_seconds": [r["seconds"] for r in ranks],
          "world1_seconds": world1["seconds"],
          "equal": _ranks_against_world1(ranks, world1, 2),
          "routes": {c: world1["results"][c]["route"]
                     for c in ("sharded_npt_k5", "sharded_npt_sk1000")}})


def sharded_ranks_on_cards(world):
    """`python3 chip_smoke.py --ranks W`: `sharded_rank_suite` on W ranks,
    one card each, over NCCL, against world 1 on this process's NCCL group
    (card 0): every result bit for bit, and each case's seconds. Needs W
    cards."""
    import torch
    import torch.distributed as dist
    from nmc_tpu_torch.ops import _build
    from nmc_tpu_torch.parallel import distributed
    from nmc_tpu_torch.parallel.dryrun import free_port, launch_ranks
    check(torch.cuda.device_count() >= world,
          f"--ranks {world} needs {world} cards, "
          f"torch sees {torch.cuda.device_count()}")
    card = phase_device()
    _build.build_all()
    t0 = time.perf_counter()
    ranks = launch_ranks("chip_smoke:sharded_rank_suite", world,
                         backend="nccl", device="cuda", payload={},
                         timeout=900, threads=2)
    launch = time.perf_counter() - t0
    check(distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0,
                                 backend="nccl"), "NCCL group")
    world1 = sharded_rank_suite("cuda", {})
    emit({"phase": "sharded_ranks_on_cards", "ranks": world,
          "backend": "nccl", "card": card, "launch_seconds": launch,
          "rank_seconds": [r["seconds"] for r in ranks],
          "world1_seconds": world1["seconds"],
          "equal": _ranks_against_world1(ranks, world1, world)})
    dist.destroy_process_group()


def phase_throughput(card, c2048, r4096, ens512, ens2048):
    import torch
    out = {"phase": "throughput", "card": card}
    prob, eng = _flagship()
    out["launch_shapes"] = {
        "colored_sweeps": _launch_shapes(torch, "colored_sweeps", prob, eng),
        "colored_sweeps_streamed": _launch_shapes(
            torch, "colored_sweeps_streamed", r4096[0], r4096[1]),
        "colored_sweeps_sparse": _launch_shapes(
            torch, "colored_sweeps_sparse", c2048[0], c2048[1])}
    out["colored_sweeps"] = _throughput_one(torch, "colored_sweeps", prob,
                                            eng, 2048, 1024, 4)
    out["colored_sweeps_sparse"] = _throughput_one(
        torch, "colored_sweeps_sparse", c2048[0], c2048[1], *SWEEP_THROUGHPUT,
        4)
    out["colored_sweeps_streamed"] = _throughput_one(
        torch, "colored_sweeps_streamed", r4096[0], r4096[1],
        *SWEEP_THROUGHPUT, 4)
    out["dense_layout"] = _dense_layout(torch)
    out["ensemble_round"] = _throughput_round(torch, "ensemble_round",
                                              ens512)
    out["ensemble_round_sparse"] = _throughput_round(
        torch, "ensemble_round_sparse", ens2048, plain_sweeps=4)
    for name in ("mitm_min", "mitm_min_i8"):
        out[name] = _throughput_exact(torch, name)
    emit(out)
    return out


# ---- the round kernels' ablation (python3 chip_smoke.py --round-ablation) ----

# Timing variants of csrc/ensemble_round.cu, each a list of (text, its
# replacement) applied to a copy of the source: "no_*" drop one piece of a
# step or sweep (their results are wrong; they only split the time); the
# others keep the arithmetic and are held bit for bit against the kernel.
# A patch that no longer applies fails the run.
_NO_ENERGY = ("        if (tid < 32) {\n          const float e = warp0_energy",
              "        if (false) {\n          const float e = warp0_energy")
_NO_GATHER = ("          gather_step(a, w, s, dm, s0, phi);",
              "          if (false) gather_step(a, w, s, dm, s0, phi);")
_NO_PHILOX = ("nmc::philox4x32_10_word0(\n                      (uint32_t)col, "
              "r_key, tg, inst_key, seed0, seed1);",
              "(uint32_t)col * 0x9E3779B9u ^ tg * 0x85EBCA6Bu ^ r_key "
              "^ seed0;")
_NO_TANHF = ("0.5f * (1.0f + tanhf(betab * phi[col]))",
             "0.5f + 0.25f * betab * phi[col]")
# the shared-memory carveout set to what 5 CTAs need, the rest left to L1
_CARVEOUT = [("    if (I == 0 || R == 0) return (int)cudaSuccess;",
              "    const size_t carve = (5 * (smem + 1024) * 100 + 233471) "
              "/ 233472;\n"
              "    err = cudaFuncSetAttribute(kernel, "
              "cudaFuncAttributePreferredSharedMemoryCarveout, "
              "(int)(carve < 100 ? carve : 100));\n"
              "    if (err != cudaSuccess) return (int)err;\n"
              "    if (I == 0 || R == 0) return (int)cudaSuccess;")]
# CTA c takes slot c % R of instance c / R, whatever its SM
_NO_CLAIMS = [("  const int r = claim[0], inst = claim[1];",
               "  const int r = blockIdx.x % a.R, inst = blockIdx.x / a.R;")]
# the wide launches (one slot an SM) at 512 threads instead of 1024
_WIDE_512 = [("    case kWide: return f(ensemble_round_kernel<kWide>, kWide);",
              "    case kWide: return f(ensemble_round_kernel<512>, 512);")]
ROUND_ABLATIONS = {
    "as_is": [], "no_sweep_energy": [_NO_ENERGY], "no_gather": [_NO_GATHER],
    "no_philox": [_NO_PHILOX], "no_tanhf": [_NO_TANHF],
    "no_energy_gather_philox_tanhf": [_NO_ENERGY, _NO_GATHER, _NO_PHILOX,
                                      _NO_TANHF],
    "l1_carveout": _CARVEOUT, "no_slot_claims": _NO_CLAIMS,
    "wide_512": _WIDE_512}
_SAME_ARITHMETIC = ("l1_carveout", "no_slot_claims", "wide_512")


def _variant_library(variant, lib, headers, patches, phase="variants"):
    """csrc/<lib>.cu and its `headers` with `patches` applied (each
    (text, replacement) to the source or (header, text, replacement); a
    patch that does not apply exactly once fails), copied under the
    ignored build directory (<phase>/<variant>), built and loaded; the
    package's own build and loaded library are untouched, so it may run
    beside `_build.build_all`."""
    import ctypes
    from nmc_tpu_torch.ops import _build
    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    texts = {f: (csrc / f).read_text() for f in [f"{lib}.cu", *headers]}
    for patch in patches:
        f, old, new = patch if len(patch) == 3 else (f"{lib}.cu", *patch)
        check(texts[f].count(old) == 1,
              f"{variant}: a patch does not apply to {f}")
        texts[f] = texts[f].replace(old, new)
    vdir = build_dir / phase / variant
    vdir.mkdir(parents=True, exist_ok=True)
    for f, text in texts.items():
        (vdir / f).write_text(text)
    return ctypes.CDLL(str(_build.build(lib, vdir, vdir / "_build")))


def _ablate(phase, lib, headers, variants, cases, turns):
    """Each variant of `variants` ({name: [(text, its replacement), ...]},
    "as_is" first; a patch (header, text, replacement) applies to that
    header) built from a patched copy of csrc/<lib>.cu and its `headers`
    under the ignored build directory (a patch that does not apply exactly
    once fails), then timed in turns: each turn one call of every case on
    every variant, so drift falls on all alike; min and median of `turns`.
    `cases` maps a name to (probe, timed): probe(variant) runs once on the
    freshly built variant, checks it and returns what to report beside its
    times; timed() is the call timed by CUDA events."""
    import statistics
    import torch
    from nmc_tpu_torch.ops import _build
    from concurrent.futures import ThreadPoolExecutor
    out = {"phase": phase, "card": phase_device(), "turns": turns}
    with ThreadPoolExecutor(max_workers=len(variants)) as pool:
        libs = dict(zip(variants, pool.map(
            lambda v: _variant_library(v, lib, headers, variants[v], phase),
            variants)))
    try:
        for variant in variants:
            _build._LIBS[lib] = libs[variant]
            out[variant] = {name: {**probe(variant), "ms": []}
                            for name, (probe, _) in cases.items()}
        for _ in range(turns):
            for variant in variants:
                _build._LIBS[lib] = libs[variant]
                for name, (_, timed) in cases.items():
                    out[variant][name]["ms"].append(
                        _event_ms(torch, timed)[0])
    finally:
        _build._LIBS.clear()
    for variant in variants:
        for name in cases:
            res = out[variant][name]
            res["min_ms"] = min(res["ms"])
            res["median_ms"] = statistics.median(res["ms"])
            res["median_vs_as_is"] = (res["median_ms"]
                                      / out["as_is"][name]["median_ms"])
        emit({"variant": variant, **out[variant]})
    emit(out)


def round_ablation(turns=9):
    """`_ablate` over ROUND_ABLATIONS, timed as `_round_kernel_times` times
    K4 and K5: one 576-sweep round at the ensemble configurations (20 instances
    x 32 slots, random states), K5 at chimera 26x26 x 16 slots (the wide
    CTA), and K5 at 20 x 16x16 over a layout of one block a step (the
    block-by-block walk's barriers in the same binary). Each variant first
    runs a short round on injected uniforms, held bit for bit against the
    kernel as is where the variant keeps its arithmetic
    (_SAME_ARITHMETIC)."""
    import torch
    from nmc_tpu_torch.ops import round_cuda as rc
    full = dict(num_cycles=3, sweeps_per_phase=64)
    reference = {}

    def case(name, ens, **kw):
        m0, cl, dn, beta, gen = _round_inputs(torch, ens, 21)
        u = torch.rand((9, 4) + tuple(m0.shape), generator=gen, device=DEVICE)
        kernel, args = _round_fns(ens)[0], (m0, cl, dn, beta)
        nbrs = kw.get("nbrs", ens.round_nbrs)

        def probe(variant):
            short = kernel(*args, None, uniforms=u, num_cycles=3,
                           sweeps_per_phase=4, **kw)
            if variant == "as_is":
                reference[name] = short
            elif variant in _SAME_ARITHMETIC:
                check(all(torch.equal(a, b) for a, b in
                          zip(short, reference[name])),
                      f"{variant}: {name} differs from the kernel")
            kernel(*args, gen, **full, **kw)              # warm-up
            slots = m0.shape[0] * m0.shape[1]
            width = rc.round_threads(slots, rc._num_sms(m0.device))
            regs, ctas = rc.kernel_occupancy(ens.n_pad, nbrs.step_spins,
                                             width)
            return {"registers": regs, "ctas_per_sm": ctas,
                    "cta_width": width,
                    "steps_per_sweep": nbrs.step_ptr.numel() - 1}

        return probe, lambda: kernel(*args, gen, **full, **kw)

    cases = {}
    for name, size in (("ensemble_round", 8), ("ensemble_round_sparse", 16)):
        _, ens, _ = _ensemble(size, 20)
        cases[name] = case(name, ens)
    col_idx, J_tiles = ens._stream_tiles
    cases["ensemble_round_sparse_block_steps"] = case(
        "ensemble_round_sparse_block_steps", ens,
        nbrs=rc.neighbors_from_tiles(
            col_idx, J_tiles, steps=range(ens.blocked0.num_blocks + 1)))
    c26, c26_kw = _c26_16_slots()
    cases["c26_16_slots"] = case("c26_16_slots", c26, **c26_kw)
    _ablate("round_ablation", "ensemble_round", ["sweep_common.cuh"],
            ROUND_ABLATIONS, cases, turns)


# ---- the exact kernels' ablation (chip_smoke.py --exact-ablation) ----

# Variants of csrc/exact_mitm.cu's shape, each a list of (text, its
# replacement) applied to a copy of the source; every one keeps the
# arithmetic on integer data and is held bit for bit against the kernel.
_EXACT_LB = "__launch_bounds__(kThreads, 3)"
_K7_TILE = "static constexpr int kTileB = {};\n  static constexpr int kRowBytes = 32 * K;"
EXACT_ABLATIONS = {
    "as_is": [],
    # the first shape built: 8 warps (512 A rows) per CTA, one CTA per SM
    "warps_8_ctas_1": [("constexpr int kWarps = 4;",
                        "constexpr int kWarps = 8;"),
                       (_EXACT_LB, "__launch_bounds__(kThreads, 1)")],
    "ctas_2": [(_EXACT_LB, "__launch_bounds__(kThreads, 2)")],
    "warps_2_ctas_4": [("constexpr int kWarps = 4;",
                        "constexpr int kWarps = 2;"),
                       (_EXACT_LB, "__launch_bounds__(kThreads, 4)")],
    "m_blocks_2": [("constexpr int kMB = 4;", "constexpr int kMB = 2;")],
    "m_blocks_8_ctas_2": [("constexpr int kMB = 4;", "constexpr int kMB = 8;"),
                          (_EXACT_LB, "__launch_bounds__(kThreads, 2)")],
    "stages_3": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
    "stages_6": [("constexpr int kStages = 4;", "constexpr int kStages = 6;")],
    "columns_per_stage_x2": [("static constexpr int kTileB = 64;",
                              "static constexpr int kTileB = 128;"),
                             (_K7_TILE.format(128), _K7_TILE.format(256))],
}


def exact_ablation(turns=5):
    """`_ablate` over EXACT_ABLATIONS, timed as the throughput phase times
    K6 and K7: one call at N = 40 on the integer planted wishart, operands
    packed once; each variant held bit for bit against the kernel as is,
    with its registers, shared memory and CTAs per SM."""
    import torch
    from nmc_tpu_torch.ops import exact_cuda as ec
    inst = _exact40()["int"]
    reference = {}

    def case(name, planes):
        use_i8, args, layout = _exact_args(torch, inst[0], planes)
        pack, launch = ((ec._pack_i8, ec._launch_i8) if use_i8
                        else (ec._pack_f32, ec._launch_f32))
        packed = pack(*args, block_a=layout[3], block_b=layout[4])
        occ = args[1].shape[0] if use_i8 else packed[0].shape[1]

        def probe(variant):
            res = launch(*packed)
            if variant == "as_is":
                reference[name] = res
            check(all(torch.equal(a, b) for a, b in
                      zip(res, reference[name])),
                  f"{variant}: {name} differs from the kernel")
            regs, smem, ctas = ec.kernel_occupancy(use_i8, occ)
            return {"registers": regs, "shared_bytes": smem,
                    "ctas_per_sm": ctas}

        return probe, lambda: launch(*packed)

    _ablate("exact_ablation", "exact_mitm", [], EXACT_ABLATIONS,
            {name: case(name, planes) for name, planes in (
                ("mitm_min", "off"), ("mitm_min_i8", "on"))}, turns)


# ---- the sweep kernels' ablation (chip_smoke.py --sweep-ablation) ----

# Timing variants of csrc/colored_sweeps_nbr.cu (K1, K2, K3): "no_*" drop one
# piece of a sweep, so their results are wrong and they only split the
# time. The others keep the arithmetic and are held bit for bit: the
# gather reads a weight once per entry at every P ("w_load_once") or only
# for a flipped source at every P ("w_load_when_flipped"; the kernel does
# the first at P > 1, the second at P = 1), and launch bounds that ask for
# 2048 / width CTAs per SM, 32 registers a thread ("full_sm_bounds"). The
# replicas per CTA (K1), the CTA widths and block steps (one step per row
# block instead of per colour class) are cases of the kernel as is, each
# held bit for bit against the rule's shape.
_SW_NO_GATHER = ("      gather_step<kP>(a, s, dm, phi);",
                 "      if (false) gather_step<kP>(a, s, dm, phi);")
_SW_NO_ENERGY = ("    if (warp < live)\n      end_of_sweep(",
                 "    if (false)\n      end_of_sweep(")
_SW_NO_PHILOX = ("nmc::philox4x32_10_word0(\n            (uint32_t)col, "
                 "d.r, (uint32_t)t, 0u, d.seed0, d.seed1);",
                 "(uint32_t)col * 0x9E3779B9u ^ (uint32_t)t * 0x85EBCA6Bu "
                 "^ d.r ^ d.seed0;")
_SW_W_ONCE = [("kP > 1 ? __ldg(a.w + e) : 0.f", "__ldg(a.w + e)"),
              ("kP > 1 ? w : __ldg(a.w + e)", "w")]
_SW_W_WHEN_FLIPPED = [
    ("      const float w = kP > 1 ? __ldg(a.w + e) : 0.f;\n", ""),
    ("kP > 1 ? w : __ldg(a.w + e)", "__ldg(a.w + e)")]
_SW_FULL_SM = ("__launch_bounds__(kWidth) colored_sweeps_nbr_kernel",
               "__launch_bounds__(kWidth, 2048 / kWidth) "
               "colored_sweeps_nbr_kernel")
SWEEP_ABLATIONS = {
    "as_is": [], "no_gather": [_SW_NO_GATHER], "no_philox": [_SW_NO_PHILOX],
    "no_sweep_energy": [_SW_NO_ENERGY],
    "no_gather_philox_energy": [_SW_NO_GATHER, _SW_NO_PHILOX, _SW_NO_ENERGY],
    "w_load_once": _SW_W_ONCE, "w_load_when_flipped": _SW_W_WHEN_FLIPPED,
    "full_sm_bounds": [_SW_FULL_SM]}
_SWEEP_SAME_ARITHMETIC = ("w_load_once", "w_load_when_flipped",
                          "full_sm_bounds")
# K1's ablation shapes on chimera 8x8: its main-path launch shape and the
# throughput shape (bench.py's R = 2048 x 1024 sweeps)
K1_ABLATION_SHAPES = ((256, 500), (2048, 1024))


def sweep_ablation(turns=7):
    """`_ablate` over SWEEP_ABLATIONS at K1's shapes (K1_ABLATION_SHAPES, on
    chimera 8x8), every main-path launch shape of K3 and K2 (LAUNCH_SHAPES)
    and their throughput shape R = 2048 x 256: per shape each (replicas
    per CTA, width) that fits (K1: P in 1, 2, 4, 8 x widths 128-1024 of at
    least 32 P; K2/K3: P = 1 at each of their widths), then block steps at
    the rule's shape; all from a burnt-in state at beta 2 (Philox). On the
    kernel as is, and on the variants that keep its arithmetic, every case
    of a shape equals the kernel as is at the rule's shape bit for bit on 4
    sweeps of injected uniforms."""
    import torch
    from nmc_tpu_torch.ops import sweeps_cuda as sc
    c512, c2048, r4096 = _flagship()[1], _chimera2048()[1], _regular3()[1]
    sms = sc._num_sms(DEVICE)
    shapes = ([("colored_sweeps", c512, R, T) for R, T in K1_ABLATION_SHAPES]
              + [("colored_sweeps_sparse", c2048, R, T)
                 for R, T, _, _ in LAUNCH_SHAPES["colored_sweeps_sparse"]]
              + [("colored_sweeps_sparse", c2048, *SWEEP_THROUGHPUT)]
              + [("colored_sweeps_streamed", r4096, R, T)
                 for R, T, _, _ in LAUNCH_SHAPES["colored_sweeps_streamed"]]
              + [("colored_sweeps_streamed", r4096, *SWEEP_THROUGHPUT)])
    block_steps = {id(eng): sc.sweep_neighbors_from_dense(
        eng.J_rows, steps=range(eng.blocked.num_blocks + 1))
        for eng in (c512, c2048, r4096)}
    reference, burnt = {}, {}
    cases = {}

    def case(shape, name, eng, R, T, P, threads, nbrs):
        gen = torch.Generator(device=DEVICE).manual_seed(5)
        u = torch.rand((4, R, eng.n_pad), generator=gen, device=DEVICE)
        betas = torch.full((max(T, 4),), 2.0, device=DEVICE)
        if name == "colored_sweeps":
            one = torch.ones((), device=DEVICE)

            def run(state, T, **kw):
                return sc.colored_sweeps(
                    eng.J_full, eng.h, state.m, state.phi, gen, betas[:T], one,
                    eng.active[None], num_sweeps=T,
                    block_size=eng.blocked.block_size, threads=threads,
                    replicas_per_cta=P, nbrs=nbrs, **kw)
        else:
            kernel = functools.partial(
                sc.colored_sweeps_sparse, *_tiles(eng)) if name == \
                "colored_sweeps_sparse" else functools.partial(
                    sc.colored_sweeps_streamed, eng.J_rows)
            ones = torch.ones(R, device=DEVICE)

            def run(state, T, **kw):
                return kernel(eng.h, state.m, state.phi, gen, betas[:T], ones,
                              eng.active[None], None, num_sweeps=T,
                              threads=threads, nbrs=nbrs, **kw)

        def probe(variant):
            if shape not in burnt:
                m0 = eng.init_states(gen, R)
                burnt[shape] = run(sc.ColoredSweepResult(
                    m0, eng.fields(m0), None, None, None), T)
            short = run(burnt[shape], 4, uniforms=u)
            if variant == "as_is" and shape not in reference:
                reference[shape] = short
            if variant == "as_is" or variant in _SWEEP_SAME_ARITHMETIC:
                check(_bit_equal(short, reference[shape]),
                      f"{variant} {shape}: P = {P}, {threads} threads / "
                      f"{len(nbrs.step_ptr) - 1} steps differ from the "
                      "kernel as is at the rule's shape")
            run(burnt[shape], T)                               # warm-up
            regs, ctas = sc.sweep_occupancy(eng.n_pad, threads, P)
            return {"replicas_per_cta": P, "threads": threads,
                    "steps": len(nbrs.step_ptr) - 1, "registers": regs,
                    "ctas_per_sm": ctas}

        return probe, lambda: run(burnt[shape], T)

    for name, eng, R, T in shapes:
        kind = {"colored_sweeps": "K1", "colored_sweeps_sparse": "K3",
                "colored_sweeps_streamed": "K2"}[name]
        shape = f"{kind} R={R}x{T}"
        if name == "colored_sweeps":
            rule = sc.k1_launch(R, eng.n_pad, sms)
            grid = [(P, w) for P in sc.K1_REPLICAS_PER_CTA
                    for w in sc.K1_WIDTHS if w >= 32 * P
                    and sc._shared_bytes_nbr(eng.n_pad, P)
                    <= sc.MAX_SHARED_BYTES]
        else:
            rule = (1, sc.sweep_threads(R, sms))
            grid = [(1, w) for w in sc.SWEEP_WIDTHS]
        for P, w in [rule] + [x for x in grid if x != rule]:
            cases[f"{shape} P={P} w={w}"] = case(shape, name, eng, R, T, P, w,
                                                 eng.sweep_nbrs)
        cases[f"{shape} P={rule[0]} w={rule[1]} block_steps"] = case(
            shape, name, eng, R, T, *rule, block_steps[id(eng)])
    _ablate("sweep_ablation", "colored_sweeps_nbr", ["sweep_common.cuh"],
            SWEEP_ABLATIONS, cases, turns)


def sequential_ablation(turns=7):
    """`_ablate` over SEQ_ABLATIONS (the in-block chain one spin a round,
    a round without runs of flips, no phi update, the chain floor) for the
    sequential kernel at
    EnsemblePT's single-instance launch (Gaussian SK-1000, SEQ_SHAPE), on
    the uncoloured Gaussian chimera 8x8 (R = 256 x 16), each at every
    replicas-per-CTA count that fits and at the rule's with injected
    uniforms in place of its Philox draws, and at EnsemblePT's batched
    launch (SK_INSTANCES x 64 x 32 sweeps, the rule's shape); from a burnt-in
    state at beta 2 (Philox; the batched case at the slot betas). On the
    kernel as is and on the variants of the same arithmetic
    (`_SEQ_SAME_ARITHMETIC`), every case of a shape equals the kernel as is
    at the rule's shape bit for bit on 4 sweeps of injected uniforms."""
    import torch
    from nmc_tpu_torch.io.generators import random_sk
    from nmc_tpu_torch.ops import sweeps_cuda as sc
    from nmc_tpu_torch.ops.engine import SweepEngine
    sk = SweepEngine(random_sk(SK_N, seed=0), device=DEVICE)
    chim = SweepEngine(_sequential_cases()[1][1], device=DEVICE)
    sms = sc._num_sms(DEVICE)
    reference, burnt, cases = {}, {}, {}

    def case(shape, eng, R, T, P):
        gen = torch.Generator(device=DEVICE).manual_seed(5)
        u = torch.rand((4, R, eng.n_pad), generator=gen, device=DEVICE)
        betas = torch.full((T,), 2.0, device=DEVICE)
        one = torch.ones((), device=DEVICE)

        def run(state, T, **kw):
            return sc.sequential_sweeps(
                eng.J_rows, eng.J_diag, eng.h, state.m, state.phi, gen,
                betas[:T], one, eng.active[None], num_sweeps=T,
                replicas_per_cta=P, nbrs=eng.sweep_nbrs, **kw)

        def probe(variant):
            if shape not in burnt:
                m0 = eng.init_states(gen, R)
                burnt[shape] = run(sc.ColoredSweepResult(
                    m0, eng.fields(m0), None, None, None), T)
            short = run(burnt[shape], 4, uniforms=u)
            if variant == "as_is" and shape not in reference:
                reference[shape] = short
            if variant == "as_is" or variant in _SEQ_SAME_ARITHMETIC:
                check(_bit_equal(short, reference[shape]),
                      f"{variant} {shape}: P = {P} differs from the kernel "
                      "as is at the rule's shape")
            run(burnt[shape], T)                               # warm-up
            n_buf = sc._tile_buffers(eng.n_pad, eng.blocked.block_size, P)
            regs, ctas = sc.sequential_occupancy(
                eng.n_pad, eng.blocked.block_size, P, n_buf)
            return {"replicas_per_cta": P, "tile_buffers": n_buf,
                    "registers": regs, "ctas_per_sm": ctas}

        return probe, lambda: run(burnt[shape], T)

    for tag, eng, R, T in (("SK-1000", sk, *SEQ_SHAPE),
                           ("chimera512", chim, 256, 16)):
        B = eng.blocked.block_size
        rule = sc.sequential_launch(1, R, eng.n_pad, B, sms)[0]
        shape = f"{tag} R={R}x{T}"
        for P in [rule] + [p for p in sc.SEQ_REPLICAS_PER_CTA if p != rule
                           and sc._seq_shared_bytes(eng.n_pad, B, p, 1)
                           <= sc.MAX_SHARED_BYTES]:
            cases[f"{shape} P={P}"] = case(shape, eng, R, T, P)
        # the rule's shape with injected uniforms in place of Philox
        probe, _ = cases[f"{shape} P={rule}"]
        u = torch.rand((T, R, eng.n_pad),
                       generator=torch.Generator(device=DEVICE).manual_seed(8),
                       device=DEVICE)
        cases[f"{shape} P={rule} injected"] = (
            lambda variant, probe=probe: probe(variant),
            lambda eng=eng, shape=shape, T=T, u=u: sc.sequential_sweeps(
                eng.J_rows, eng.J_diag, eng.h, burnt[shape].m,
                burnt[shape].phi, None, torch.full((T,), 2.0, device=DEVICE),
                torch.ones((), device=DEVICE), eng.active[None],
                num_sweeps=T, nbrs=eng.sweep_nbrs, uniforms=u))
    _, ens, st, phi, beta_slot = _sk_ensemble(torch, SK_INSTANCES, False)
    T = ens.cfg.sweeps_per_round
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    ones = torch.ones(T, device=DEVICE)

    def batched(m, phi):
        return sc.sequential_sweeps_batched(
            ens.J_rows, ens.J_diag, ens.h, m, phi, gen, ones, beta_slot,
            ens.active, num_sweeps=T, nbrs=ens.sweep_nbrs)
    warm = batched(st.m, phi)
    cases[f"EnsemblePT {SK_INSTANCES}x{SK_REPLICAS}x{T}"] = (
        lambda variant: (batched(warm.m, warm.phi), {})[1],
        lambda: batched(warm.m, warm.phi))
    _ablate("sequential_ablation", "sequential_sweeps", ["sweep_common.cuh"],
            SEQ_ABLATIONS, cases, turns)


def sweep_times(tree, kernels=True):
    """K1, K2 and K3 alone (CUDA events, beta 2) at their main-path launch
    shapes (`_launch_shapes`) and their throughput shapes (K1 R = 2048 x
    1024, K2/K3 SWEEP_THROUGHPUT) and K4 / K5 a round at their launches
    (`_round_kernel_times`), unless not `kernels`; then the sequential route alone (CUDA events, Philox) at
    EnsemblePT's single-instance launch (Gaussian SK-1000, SEQ_SHAPE, beta
    2), on the uncoloured Gaussian chimera 8x8 (R = 256 x 16, beta 2) and
    at the contrived ICM round's launch (R = 320, 576 sweeps, its slot
    betas; median of 3), EnsemblePT's seconds per round (100 SK-1000 x
    64, 1 round to warm up, 2 timed) and the compat phase's seconds per
    shim (chimera128, R = 1-64; `phase_compat`), through the chip_smoke.py
    and nmc_tpu_torch of the checkout at `tree`: run it from two checkouts
    in turns (parent, change, change, parent) to compare them on one card.
    Prints one JSON line."""
    sys.path.insert(0, str(tree))
    import torch
    import chip_smoke as c          # the one in `tree`
    out = {"tree": str(tree), "card": c.phase_device()}
    if kernels:
        _kernel_times(torch, c, out)
    from nmc_tpu_torch.io.generators import random_sk
    from nmc_tpu_torch.ops import sweeps_cuda as sc
    from nmc_tpu_torch.ops.engine import SweepEngine
    from nmc_tpu_torch.parallel import EnsembleConfig, EnsemblePT
    sk = random_sk(c.SK_N, seed=0)
    for tag, prob, R in (("sequential_sweeps", sk, c.SEQ_SHAPE[0]),
                         ("sequential_chimera512",
                          c._sequential_cases()[1][1], 256)):
        seq = c._throughput_one(torch, "sequential_sweeps", prob,
                                SweepEngine(prob, device=c.DEVICE), R, 16, 4,
                                with_plain=False)
        out[tag] = {k: seq[k] for k in (
            "R", "sweeps", "kernel_ms_per_call", "bound_ms",
            "flips_per_attempt")}
    eng, m, beta_spin, mask, T = c._icm_round_contrived(torch)
    gen = torch.Generator(device=c.DEVICE).manual_seed(1)
    ones = torch.ones((T,), device=c.DEVICE)

    def icm():
        return sc.sequential_sweeps(
            eng.J_rows, eng.J_diag, eng.h, m, eng.fields(m), gen, ones,
            beta_spin, mask, num_sweeps=T, nbrs=eng.sweep_nbrs)
    icm()
    out["sequential_icm_contrived"] = {
        "R": m.shape[0], "sweeps": T, "ms": float(np.median(
            [c._event_ms(torch, icm)[0] for _ in range(3)]))}
    ens = EnsemblePT([random_sk(c.SK_N, seed=s)
                      for s in range(c.SK_INSTANCES)],
                     np.geomspace(0.1, 3.0, c.SK_REPLICAS),
                     EnsembleConfig(num_replicas=c.SK_REPLICAS),
                     device=c.DEVICE)
    st = ens.run(ens.init_state(
        torch.Generator(device=c.DEVICE).manual_seed(0)), 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ens.run(st, 2)
    torch.cuda.synchronize()
    out["ensemble_pt"] = {"seconds_per_round":
                          (time.perf_counter() - t0) / 2}
    compat, c.emit = [], lambda obj: compat.append(obj)
    c.phase_compat()
    out["compat_seconds"] = {k: v["seconds"] for k, v in compat[0].items()
                             if isinstance(v, dict) and "seconds" in v}
    emit(out)


def _kernel_times(torch, c, out):
    """`sweep_times`' K1-K5 part through the chip_smoke.py `c` of a
    checkout, into `out`."""
    c512, c2048, r4096 = c._flagship(), c._chimera2048(), c._regular3()[:2]
    for name, (prob, eng), shape in (
            ("colored_sweeps", c512, (2048, 1024)),
            ("colored_sweeps_sparse", c2048, c.SWEEP_THROUGHPUT),
            ("colored_sweeps_streamed", r4096, c.SWEEP_THROUGHPUT)):
        out[name] = {
            "launch_shapes": [{k: r[k] for k in ("R", "sweeps", "ms",
                                                 "bound_ms")}
                              for r in c._launch_shapes(torch, name, prob,
                                                        eng)],
            "throughput_ms": c._throughput_one(
                torch, name, prob, eng, *shape, 4,
                with_plain=False)["kernel_ms_per_call"]}
    _round_kernel_times(torch, c, out)


def _round_kernel_times(torch, c, out):
    """K4 and K5 alone (CUDA events, Philox, median of 5 after a warm-up;
    the ICM shape through `_icm_kernel_ms`) at their launches: one
    576-sweep round at 20 chimera 8x8 / 16x16 instances x 32 slots (the
    ensembles'), a pure-ICM round at 20 x 320 slots (EnsembleICM's), and
    K5 at chimera 26x26 x 16 slots (`_c26_16_slots`); with the chip_smoke.py
    `c` and package of a checkout, into `out`. Where the package has CTA
    widths, each launch is also timed at every width, forced
    (`round_ms_by_width`)."""
    from nmc_tpu_torch.ops import round_cuda as rc
    widths = getattr(rc, "ROUND_WIDTHS", ())
    full = dict(num_cycles=3, sweeps_per_phase=64)

    def timed(call):
        call()
        return float(np.median([c._event_ms(torch, call)[0]
                                for _ in range(5)]))

    def by_width(res, ms):
        res["round_ms"] = ms()
        if widths:
            res["cta_width"] = rc.round_threads(res["slots"],
                                                rc._num_sms(DEVICE))
        res["round_ms_by_width"] = {}
        for w in widths:
            with _round_width(rc, w):
                res["round_ms_by_width"][w] = ms()
        out[res.pop("name")] = res

    for name, size in (("ensemble_round", 8), ("ensemble_round_sparse", 16)):
        _, ens, _ = c._ensemble(size, 20)
        m0, cl, dn, beta, gen = c._round_inputs(torch, ens, 5)
        kernel = c._round_fns(ens)[0]
        by_width({"name": name, "slots": 20 * 32},
                 lambda: timed(lambda: kernel(m0, cl, dn, beta, gen,
                                              **full)))
        _, ens, _ = c._icm_ensemble(size, 20)
        state = ens.init_state(torch.Generator(device=DEVICE).manual_seed(5))
        by_width({"name": f"{name}_icm", "slots": 20 * 320},
                 lambda: c._icm_kernel_ms(torch, ens, state)[
                     "kernel_ms_per_round"])
        del ens, state
    ens, kw = _c26_16_slots()
    m0, cl, dn, beta, gen = c._round_inputs(torch, ens, 7)
    kernel = c._round_fns(ens)[0]
    by_width({"name": "ensemble_round_sparse_c26_16_slots", "slots": 16},
             lambda: timed(lambda: kernel(m0, cl, dn, beta, gen, **kw,
                                          **full)))


def main():
    import torch
    if sys.argv[1:2] == ["--sweep-times"]:
        args = sys.argv[2:]
        trees = [a for a in args if a != "--sequential"] or ["."]
        sweep_times(trees[0], kernels="--sequential" not in args)
        return
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test runs on a CUDA card only", file=sys.stderr)
        sys.exit(1)
    import nmc_tpu_torch  # noqa: F401  (fails here outside a checkout)
    if sys.argv[1:] == ["--round-ablation"]:
        round_ablation()
        return
    if sys.argv[1:] == ["--exact-ablation"]:
        exact_ablation()
        return
    if sys.argv[1:] == ["--sweep-ablation"]:
        sweep_ablation()
        return
    if sys.argv[1:] == ["--sequential-ablation"]:
        sequential_ablation()
        return
    if sys.argv[1:2] == ["--ranks"]:
        sharded_ranks_on_cards(int(sys.argv[2]))
        return
    if sys.argv[1:] == ["--label-swaps"]:
        phase_device()
        phase_label_swaps()
        phase_ensemble_2048()
        return
    t_start = time.perf_counter()
    card = phase_device()
    floor_lib = phase_build()
    c2048, r4096 = _chimera2048(), _regular3()
    errs = {"colored_sweeps": phase_kernel()}
    errs.update(phase_streamed_kernels(c2048, r4096))
    errs["sequential_sweeps"], seq_tp = phase_sequential_kernel(floor_lib)
    launches = {"colored_sweeps": phase_nmc_512(),
                "colored_sweeps_sparse": phase_nmc_2048(c2048)}
    launches["colored_sweeps_sparse"] += phase_npt_2048(c2048)
    launches["colored_sweeps_streamed"] = phase_nmc_4096(r4096)
    errs.update(phase_round_kernels())
    launches["ensemble_round"], ens512 = phase_ensemble_512()
    launches["ensemble_round_sparse"], ens2048 = phase_ensemble_2048()
    launches["ensemble_round"] += phase_campaign()
    phase_round_routing()
    launches["ensemble_round"] += phase_ensemble_icm_512()
    k5, icm2048 = phase_ensemble_icm_2048()
    launches["ensemble_round_sparse"] += k5
    phase_houdayer(icm2048)
    del icm2048
    launches["ensemble_round"] += phase_hybrid_512()
    for name, count in phase_campaign_icm().items():
        launches[name] += count
    for name, count in phase_apt_icm(c2048).items():
        launches[name] += count
    launches["sequential_sweeps"] = phase_compat()
    launches["sequential_sweeps_batched"], batched_tp = phase_ensemble_pt()
    errs["sequential_sweeps_batched"] = batched_tp["max_abs_err"]
    _, swaps_tp = phase_label_swaps()
    errs["label_swaps"] = swaps_tp["max_abs_err"]
    phase_native_clusters()
    phase_spectral()
    phase_solve_wishart()
    launches["sequential_sweeps"] += phase_solve_contrived()
    launches["ensemble_round_sparse"] += phase_solve_chimera2048()
    phase_refine_128()
    launches["ensemble_round"] += phase_campaign_spectral()
    phase_beam_parity()
    phase_beam_2048()
    launches["colored_sweeps"] += phase_evaluate_512()
    errs.update(phase_exact_kernels())
    exact_launches, k6_energy = phase_exact_40()
    launches.update(exact_launches)
    phase_exact_enum(k6_energy)
    phase_exact_tiers()
    phase_sharded_offsets(c2048, r4096)
    for name, count in phase_sharded_npt(card).items():
        launches[name] += count
    phase_sharded_ranks(card)
    tp = phase_throughput(card, c2048, r4096, ens512, ens2048)
    tp["sequential_sweeps"] = seq_tp
    tp["sequential_sweeps_batched"] = batched_tp
    tp["label_swaps"] = swaps_tp
    launches["label_swaps"] = MAIN_PATH_SWAPS["launches"]
    import torch.distributed as dist
    dist.destroy_process_group()          # sharded_npt's NCCL group
    for name in ("mitm_min", "mitm_min_i8"):
        errs[name] = max(errs[name], tp[name]["max_abs_err"])
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    sources = {"colored_sweeps": ("nmc_tpu_torch/csrc/colored_sweeps_nbr.cu",
                                  "nmc_tpu/ops/sweeps_pallas.py:128"),
               "colored_sweeps_streamed": (
                   "nmc_tpu_torch/csrc/colored_sweeps_nbr.cu",
                   "nmc_tpu/ops/sweeps_pallas.py:291"),
               "colored_sweeps_sparse": (
                   "nmc_tpu_torch/csrc/colored_sweeps_nbr.cu",
                   "nmc_tpu/ops/sweeps_pallas.py:493"),
               "sequential_sweeps": (
                   "nmc_tpu_torch/csrc/sequential_sweeps.cu",
                   "nmc_tpu/ops/sweeps.py:71"),
               "sequential_sweeps_batched": (
                   "nmc_tpu_torch/csrc/sequential_sweeps.cu",
                   "nmc_tpu/ops/sweeps.py:71"),
               "ensemble_round": ("nmc_tpu_torch/csrc/ensemble_round.cu",
                                  "nmc_tpu/ops/round_pallas.py:458"),
               "ensemble_round_sparse": (
                   "nmc_tpu_torch/csrc/ensemble_round.cu",
                   "nmc_tpu/ops/round_pallas.py:340"),
               "mitm_min": ("nmc_tpu_torch/csrc/exact_mitm.cu",
                            "nmc_tpu/ops/exact_pallas.py:85"),
               "mitm_min_i8": ("nmc_tpu_torch/csrc/exact_mitm.cu",
                               "nmc_tpu/ops/exact_pallas.py:166"),
               "label_swaps": ("nmc_tpu_torch/csrc/label_swaps.cu", None)}
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "launches": launches[name], "max_abs_err": errs[name],
        "ms": tp[name]["kernel_ms_per_call"],
        "plain_ms": tp[name]["plain_ms_per_call"],
        "bound_ms": tp[name]["bound_ms"], "bound_by": tp[name]["bound_by"],
        "library_ms": None} for name, (src, rep) in sources.items()]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
