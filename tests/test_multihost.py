"""Multi-process multihost exercise.

Two real OS processes under ``jax.distributed.initialize`` (CPU backend,
4 virtual devices each -> an 8-device global mesh with Gloo collectives)
assemble a split corpus via ``assemble_multiprocess`` and must both
produce the single-process result node-for-node.  ``local_read_slice``
is unit-tested in-process.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import json, os, sys
pid = int(sys.argv[1]); port = sys.argv[2]; outp = sys.argv[3]
repo = sys.argv[4]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, repo)
# distributed bootstrap MUST precede anything that initializes the XLA
# backend, including the tpu_debruijn import (module-level jnp constants)
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=pid)
# PRIVATE per-rank cache dir: both workers compile the same programs at
# the same time, and concurrent writes of the same entry to a shared
# cache dir corrupt it — the parent (and later tests) then segfault
# deserializing/compiling (repro'd as full-suite crashes in whatever big
# compile followed this test).
from tpu_debruijn import compile_cache
compile_cache.configure(f".jax_cache_cpu_rank{pid}")
from tpu_debruijn.parallel.multihost import (
    assemble_multiprocess, local_read_slice,
)
assert jax.device_count() == 8 and jax.local_device_count() == 4

# local_read_slice: round-robin, disjoint, complete
paths = [f"f{i}" for i in range(7)]
mine = local_read_slice(paths)
assert mine == [p for i, p in enumerate(paths) if i % 2 == pid]

import numpy as np
rng = np.random.default_rng(123)  # SAME corpus in every process
genome = rng.integers(0, 4, 800).astype(np.uint8)
reads = []
for _ in range(64):
    s = int(rng.integers(0, 700))
    r = genome[s : s + 90].copy()
    if rng.random() < 0.5:
        r = (3 - r[::-1]).astype(np.uint8)
    reads.append(r)
local = [r for i, r in enumerate(reads) if i % 2 == pid]  # split corpus

g = assemble_multiprocess(local, 31, 8, stranded=False, min_obs=1)

# overflow auto-resize: a deliberately tiny explicit cap_per_dest must
# histogram-resize and retry, NOT hard-error (matches the single-process
# count-then-allocate default)
g2 = assemble_multiprocess(local, 31, 8, stranded=False, min_obs=1,
                           cap_per_dest=16)
def canon_rows(gr):
    out = []
    for i in range(len(gr)):
        b = gr.base.sequences.get_bases(i)
        rc = (3 - b[::-1]).astype(np.uint8)
        out.append(list(min(tuple(int(x) for x in b), tuple(int(x) for x in rc))))
    return sorted(out)
assert canon_rows(g2) == canon_rows(g), "overflow retry changed the graph"

rows = []
for i in range(len(g)):
    b = g.base.sequences.get_bases(i)
    rc = (3 - b[::-1]).astype(np.uint8)
    fwd, rev = tuple(int(x) for x in b), tuple(int(x) for x in rc)
    rows.append(list(min(fwd, rev)))
with open(outp, "w") as f:
    json.dump(sorted(rows), f)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_assembly_equals_single(tmp_path):
    # bounded by communicate(timeout=280) below; pytest-timeout not installed
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    port = _free_port()
    outs = [tmp_path / f"out{i}.json" for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), str(port), str(outs[i]),
             REPO],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO,
        )
        for i in range(2)
    ]
    logs = [p.communicate(timeout=280)[0].decode() for p in procs]
    for p, lg in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{lg[-3000:]}"
    got = [json.loads(o.read_text()) for o in outs]
    assert got[0] == got[1] and got[0], "processes disagree"

    # single-process truth on the full corpus
    from tpu_debruijn import compress as C
    from tpu_debruijn import filter as F

    rng = np.random.default_rng(123)
    genome = rng.integers(0, 4, 800).astype(np.uint8)
    reads = []
    for _ in range(64):
        s = int(rng.integers(0, 700))
        r = genome[s : s + 90].copy()
        if rng.random() < 0.5:
            r = (3 - r[::-1]).astype(np.uint8)
        reads.append(r)
    table = F.filter_kmers([(r, 0, 0) for r in reads], 31, stranded=False, min_obs=1)
    nodes = C.compress_kmers(table)
    want = []
    for seq, _, _ in nodes:
        b = np.asarray(seq, np.uint8)
        rc = (3 - b[::-1]).astype(np.uint8)
        want.append(list(min(tuple(int(x) for x in b), tuple(int(x) for x in rc))))
    assert got[0] == sorted(want)
