"""The port's row-sharded search across OS processes on ``torch.distributed``.

``python -m typeagent_tpu_torch.parallel.multislice`` runs as 2 real
processes on gloo, each with a (dp=2, shard=2) mesh of CPU devices holding
its half of the rows, joined at a loopback ``tcp://`` address; the
winners are gathered with ``all_gather`` and every process checks the
merged answer against a numpy oracle (the counterpart of the JAX package's
``tests/test_multislice.py``). Each process has its own time limit.
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROCESS_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_multislice_dryrun_two_processes():
    coordinator = f"127.0.0.1:{_free_port()}"
    num_processes = 2
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "typeagent_tpu_torch.parallel.multislice",
             coordinator, str(num_processes), str(pid), "4", "cpu"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(num_processes)
    ]
    outputs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=PROCESS_TIMEOUT_S)
            outputs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for pid, (proc, out) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0, f"process {pid} failed:\n{out}"
        assert "multislice dryrun OK" in out, out
        assert "4 shards in all" in out, out
