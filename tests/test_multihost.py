"""Two-process jax.distributed smoke: launches
scripts/multihost_smoke.py twice (rank 0/1, localhost coordinator), each with
4 virtual CPU devices, asserts both ranks bootstrap through the CLI's --dist
plumbing, psum across the 8-device global mesh, run one tile-sharded render,
and agree on the loss."""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "multihost_smoke.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_bootstrap_psum_render():
    # (subprocess.communicate carries its own 540 s timeout below)
    port = _free_port()
    coord = f"localhost:{port}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # the script sets its own device count
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, SCRIPT, "--coord", coord, "--nprocs", "2",
             "--rank", str(r)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO,
        )
        for r in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
        assert "MULTIHOST_OK" in out, f"rank {r}:\n{out[-3000:]}"
    losses = [
        line.split()[1]
        for out in outs
        for line in out.splitlines()
        if line.startswith("MULTIHOST_OK")
    ]
    assert len(losses) == 2 and losses[0] == losses[1], losses
