"""Bring-up measurements on a GPU: the numbers behind the bring-up decisions.

1. Copy bandwidth, and XLA's fused ``canonicalize`` at the count step's
   widths as a share of it.
2. The count program's front end (``extract_kmers`` + ``canonicalize``)
   against the whole count step, at the smoke's phase-A batch (all reads
   in one ``filter_kmers`` call) and at ``bench.py``'s 8192 x 160 batch:
   the front end's time alone (outputs materialized), its time over its
   byte floor (bases read once; limbs, exts and valid written once; over
   the copy bandwidth), the count step's time, and — from a profiler trace
   reduced to device time per HLO op — the device time of the ops under
   the step's ``frontend`` name scope.  Run with
   ``XLA_FLAGS=--xla_gpu_enable_command_buffer=`` for that split: with
   command buffers on, the trace shows the whole step as one event.
3. ``compress_kmers`` on the phase-A table by its two routes: sequence
   assembly on the device (the default policy's route) and on the host
   (the route of an explicit ``spec``), timed in turns.

Timings are host-clock windows ended by ``block_until_ready``, best of
three after a compiling call.  Run on the card:

    python scripts/bringup_measure.py [--corpus-scale 1.0] [--out FILE]
"""

import argparse
import glob
import json
import os
import re
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def best_of(fn, reps=3):
    import jax

    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def device_time_by_op(fn, compiled_text: str):
    """Trace one call of ``fn``; return (total device ns, front-end ns,
    top ops) from the GPU planes, attributing each event to its HLO op's
    ``op_name`` metadata."""
    import jax
    from jax import profiler

    scope = {}
    for m in re.finditer(r"%?([\w.\-]+) = [^\n]*?op_name=\"([^\"]*)\"",
                         compiled_text):
        scope[m.group(1)] = m.group(2)
    d = tempfile.mkdtemp(prefix="trace", dir=os.path.join(REPO, "out"))
    jax.block_until_ready(fn())
    with profiler.trace(d):
        jax.block_until_ready(fn())
    path = glob.glob(os.path.join(d, "**", "*.xplane.pb"), recursive=True)[0]
    total = front = 0
    per_op = {}
    for plane in profiler.ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                op = dict(ev.stats).get("hlo_op")
                if op is None:
                    continue
                dur = int(ev.duration_ns)
                total += dur
                per_op[op] = per_op.get(op, 0) + dur
                if "frontend" in scope.get(op, ""):
                    front += dur
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:12]
    return total, front, [(op, ns, scope.get(op, "")) for op, ns in top]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus-scale", type=float, default=1.0)
    ap.add_argument("--out", default=os.path.join(REPO, "out", "bringup.json"))
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tpu_debruijn import compile_cache

    compile_cache.configure()
    from bench import make_reads, measure_copy_bw
    from chip_smoke import K, MIN_OBS, card_line, make_corpus
    from tpu_debruijn import compress as C
    from tpu_debruijn import filter as F
    from tpu_debruijn.kmer import KmerSpec

    os.makedirs(os.path.join(REPO, "out"), exist_ok=True)
    dev = jax.devices()[0]
    res = {"card": card_line(), "device": dev.device_kind,
           "platform": dev.platform}
    print(res, flush=True)
    bw = measure_copy_bw(jnp)
    res["copy_GBps"] = bw / 1e9
    spec = KmerSpec(K)

    _, reads = make_corpus(0, args.corpus_scale)
    shapes = {
        "phaseA": F.pad_reads(list(reads), min_len=K, pad_to=16),
        "bench_8192x160": (make_reads(8192, 160, 100_000),
                           np.full(8192, 160, np.int32)),
    }
    for name, (bases, lengths) in shapes.items():
        r, ln = bases.shape
        lk = ln - K + 1
        z = np.zeros(r, np.int32)
        args_d = [jax.device_put(a) for a in (bases, lengths, z, z)]
        # phase A: what filter_kmers compiles; bench: bench.py's count_api
        min_obs, reduce = ((MIN_OBS, "label_first") if name == "phaseA"
                           else (1, "none"))
        count_j = jax.jit(lambda b, l, e, lab: F.count_kmers(
            spec, b, l, e, lab, stranded=False, min_obs=min_obs,
            data_reduce=reduce, report_all=False))
        front_j = jax.jit(
            lambda b, l, e: F.extract_canonical(spec, b, l, e, False))
        t_count = best_of(lambda: count_j(*args_d))
        t_front = best_of(lambda: front_j(*args_d[:3]))
        t_floor = (r * ln + r * lk * (spec.w * 4 + 4 + 1)) / bw
        try:
            text = count_j.lower(*args_d).compile().as_text()
            dev_ns, front_ns, top = device_time_by_op(
                lambda: count_j(*args_d), text)
        except Exception as exn:  # the trace is evidence, not a gate
            dev_ns, front_ns, top = 0, 0, [repr(exn)]
        km, ex, _ = jax.jit(
            lambda b, l, e: F.extract_kmers(spec, b, l, e))(*args_d[:3])
        canon_j = jax.jit(lambda a, e: F.canonicalize(spec, a, e, False))
        t_canon = best_of(lambda: canon_j(km, ex))
        canon_bytes = 2 * km.size * 4 + 2 * ex.size * 4 + ex.size
        del km, ex, args_d
        res[name] = {
            "reads": r, "width": ln, "observations": r * lk,
            "count_s": t_count, "frontend_s": t_front,
            "frontend_share_of_count": t_front / t_count,
            "frontend_floor_s": t_floor,
            "frontend_over_floor": t_front / t_floor,
            "trace_device_s": dev_ns / 1e9,
            "trace_frontend_s": front_ns / 1e9,
            "trace_frontend_share": front_ns / max(dev_ns, 1),
            "canonicalize_s": t_canon,
            "canonicalize_share_of_copy_bw": canon_bytes / t_canon / bw,
            "trace_top_ops": top,
        }
        print(name, json.dumps({k: v for k, v in res[name].items()
                                if k != "trace_top_ops"}), flush=True)

    # compress routes on the phase-A table
    table = F.filter_kmers([(rr, 0, 0) for rr in reads], K, stranded=False,
                           min_obs=MIN_OBS)
    device_route = lambda: C.compress_kmers(table)
    host_route = lambda: C.compress_kmers(
        table, spec=C.SimpleCompress("sum_sat_u16"))
    a = device_route()
    b = host_route()
    same = [(s.tobytes(), e, d) for s, e, d in a] == [
        (np.asarray(s, np.uint8).tobytes(), e, d) for s, e, d in b]
    times = {"device": [], "host": []}
    for route in ("device", "host", "host", "device"):
        fn = device_route if route == "device" else host_route
        t0 = time.perf_counter()
        fn()
        times[route].append(time.perf_counter() - t0)
    res["compress"] = {"table_kmers": len(table), "unitigs": len(a),
                       "routes_agree": same,
                       "device_route_s": times["device"],
                       "host_route_s": times["host"]}
    print("compress", res["compress"], flush=True)
    res["card_after"] = card_line()
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: res[k] for k in ("card", "copy_GBps")}))


if __name__ == "__main__":
    main()
