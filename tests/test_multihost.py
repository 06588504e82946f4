"""Multi-process group tests (SURVEY.md §2.4 + §5 fault injection).

These drive REAL processes (subprocesses of this test) joined via
``jax.distributed.initialize`` with cross-process CPU collectives — not
just virtual devices in one process.  The fault-injection case SIGKILLs
one worker mid-serve and asserts (a) the survivor stops making progress
(peer death is detected — collectives cannot silently produce wrong
answers) and (b) a relaunched group reproduces identical answers from the
immutable artifact (restart-on-crash recovery, the reference's model).
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
WORKER = [sys.executable, "-m", "readserver_tpu.bench.multihost_bench"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ)
    # workers pick their own platform/device flags; scrub the test
    # harness's CPU-sim forcing so it doesn't leak a conflicting count
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _launch(port: int, pid: int, nproc: int, extra: list[str]):
    return subprocess.Popen(
        WORKER
        + [
            "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", str(nproc),
            "--process-id", str(pid),
            "--local-devices", "2",
            "--batch", "32",
            "--heartbeat-timeout", "10",
        ]
        + extra,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
        env=_env(),
        cwd=REPO,
    )


def _run_group(port: int, extra: list[str], timeout: float = 240.0):
    p1 = _launch(port, 1, 2, extra)
    p0 = _launch(port, 0, 2, extra)
    out0, _ = p0.communicate(timeout=timeout)
    out1, _ = p1.communicate(timeout=timeout)
    return p0.returncode, out0, p1.returncode, out1


@pytest.mark.slow
def test_two_process_sharded_parity():
    rc0, out0, rc1, out1 = _run_group(_free_port(), ["--iters", "4"])
    assert rc0 == 0, out0
    assert rc1 == 0, out1
    line = [l for l in out0.splitlines() if l.startswith("{")][-1]
    res = json.loads(line)
    assert res["processes"] == 2
    assert res["devices"] == 4
    assert res["parity_bad"] == 0
    assert res["parity_queries"] == 64


@pytest.mark.slow
def test_two_process_small_scale_stress():
    """Beyond-toy 2-process case: a ~1.2M-symbol corpus with
    owner-routed ranks at a deliberately undersized capacity (forces the
    local overflow while_loop rounds), the direct-resolve tier stripped
    (forces the sampled-LF walk's per-step cross-process collectives),
    and the exact-attribution sweep on — full count parity required."""
    rc0, out0, rc1, out1 = _run_group(
        _free_port(),
        [
            "--iters", "2", "--config", "small", "--scale", "4",
            "--owner-route", "--route-capacity", "64",
            "--strip-dsa", "--exact-hist",
        ],
        timeout=420.0,
    )
    assert rc0 == 0, out0
    assert rc1 == 0, out1
    res = json.loads([l for l in out0.splitlines() if l.startswith("{")][-1])
    assert res["parity_bad"] == 0
    assert res["parity_queries"] == 64


@pytest.mark.slow
def test_fault_injection_sigkill_and_rejoin_by_reload():
    port = _free_port()
    p1 = _launch(port, 1, 2, ["--serve-loop"])
    p0 = _launch(port, 0, 2, ["--serve-loop"])
    fd = p0.stdout.fileno()
    os.set_blocking(fd, False)

    def drain() -> str:
        out = b""
        while True:
            try:
                chunk = os.read(fd, 65536)
            except BlockingIOError:
                break
            if not chunk:
                break
            out += chunk
        return out.decode(errors="replace")

    # wait until the group is serving (ticks flowing from proc 0)
    ticks = 0
    deadline = time.time() + 210
    buf = ""
    while ticks < 3 and time.time() < deadline:
        buf += drain()
        ticks = buf.count(" ok ")
        time.sleep(0.1)
    assert ticks >= 3, f"group never started serving: {buf[-2000:]}"

    # SIGKILL the peer mid-serve
    os.kill(p1.pid, signal.SIGKILL)
    p1.wait(timeout=30)

    # the survivor must stop making progress (its collectives cannot
    # complete without the peer) — "failure detection" for an SPMD group
    time.sleep(2.0)
    buf += drain()
    base = buf.count(" ok ")
    stalled_or_dead = False
    for _ in range(100):  # up to ~20s
        if p0.poll() is not None:
            stalled_or_dead = True  # peer death detected → process exited
            break
        buf += drain()
        time.sleep(0.2)
    if not stalled_or_dead:
        stalled_or_dead = buf.count(" ok ") <= base + 1  # no real progress
    assert stalled_or_dead, "survivor kept serving without its peer"
    if p0.poll() is None:
        p0.kill()
    p0.wait(timeout=30)

    # recovery = relaunch-and-reload (the index is immutable): the fresh
    # group must answer with full parity — same JSON the healthy run gives
    rc0, out0, rc1, out1 = _run_group(_free_port(), ["--iters", "2"])
    assert rc0 == 0, out0
    assert rc1 == 0, out1
    res = json.loads([l for l in out0.splitlines() if l.startswith("{")][-1])
    assert res["parity_bad"] == 0


@pytest.mark.slow
def test_multihost_rest_serving():
    """Two `cli serve` processes: proc 0 fronts REST, proc 1 follows;
    served counts equal the oracle's."""
    import urllib.request

    import numpy as np

    from readserver_tpu import alphabet
    from readserver_tpu.corpus import simulate
    from readserver_tpu.index import artifact, build_index
    from readserver_tpu.oracle import OracleFMIndex

    corpus = simulate.simulate_config("tiny")
    packed = build_index(corpus.reads, sample_ids=corpus.sample_ids)
    import tempfile

    tmp = tempfile.mkdtemp(prefix="mh_idx_")
    artifact.save_artifact(packed, tmp)

    coord = _free_port()
    rest = _free_port()
    env = _env()
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    cmd = [
        sys.executable, "-m", "readserver_tpu.cli", "serve",
        "--index", tmp, "--port", str(rest), "--batch", "16",
        "--coordinator", f"127.0.0.1:{coord}", "--num-processes", "2",
    ]
    procs = [
        subprocess.Popen(
            cmd + ["--process-id", str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=REPO,
        )
        for i in (1, 0)
    ]
    try:
        deadline = time.time() + 210
        up = False
        while time.time() < deadline:
            if any(p.poll() is not None for p in procs):
                outs = [p.communicate()[0] for p in procs]
                raise AssertionError(f"serve died early: {outs}")
            try:
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{rest}/health", timeout=2
                ) as r:
                    if r.status == 200:
                        up = True
                        break
            except Exception:
                time.sleep(0.5)
        assert up, "REST front end never came up"

        fm = OracleFMIndex(corpus.reads)
        kmers = simulate.sample_query_kmers(
            corpus, 6, corpus.spec.kmer_len, seed=51, miss_frac=0.3
        )
        for km in kmers:
            s = alphabet.decode(np.asarray(km))
            with urllib.request.urlopen(
                f"http://127.0.0.1:{rest}/count?kmer={s}", timeout=60
            ) as r:
                got = json.loads(r.read())
            l, u = fm.backward_search(km)
            assert got["count"] == u - l, s
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
