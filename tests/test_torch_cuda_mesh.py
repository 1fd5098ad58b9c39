"""The port's multi-card paths on the card: a kernel launched on a card
that is not the current device, and the 2-process multislice run on NCCL.

Both need two or more cards and skip on fewer (NCCL does not let two
processes share one card). On the card's machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_mesh.py -q
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from typeagent_tpu_torch.ops import topk
from typeagent_tpu_torch.parallel import ShardedVectorStore, create_mesh

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.backends.cuda.matmul.allow_tf32 = False


def test_launch_on_a_card_that_is_not_current(two_cards):
    """K1, K2 and K3 on cuda:1 while cuda:0 is current: the launch runs on
    the tensor's card and equals the plain version there; a mesh over both
    cards answers as one card does."""
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 1)
    rng = np.random.default_rng(0)
    m = rng.standard_normal((8192, 256)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    emb = torch.from_numpy(m).to(dev)
    q = emb[:16].clone()
    vals, idx = topk.fused_topk(emb, q, 8000, 10)
    pv, _ = topk.topk_plain(emb, q, 8000, 10)
    assert vals.device == dev and (vals - pv).abs().max().item() <= 2e-6
    maxima = topk.bucket_maxima(emb.bfloat16(), q, 8000)
    plain = topk.bucket_maxima_plain(emb.bfloat16(), q, 8000)
    assert (maxima - plain).abs().max().item() <= 1e-5
    ids = torch.zeros((16, 4), dtype=torch.int32, device=dev)
    got = topk.rescore_selected(emb, q, ids)
    assert (got - topk.rescore_selected_plain(emb, q, ids)).abs().max().item() <= 2e-6
    assert torch.cuda.current_device() == 0
    mesh = create_mesh(n_shard=2, devices=[torch.device("cuda", 0), dev])
    store = ShardedVectorStore(256, mesh=mesh)
    one = ShardedVectorStore(256, device="cuda:0")
    for s in (store, one):
        s.append(m)
    assert store.search(m[:8], 10) == one.search(m[:8], 10)


def test_multislice_two_processes_on_nccl(two_cards):
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "typeagent_tpu_torch.parallel.multislice",
             f"127.0.0.1:{port}", "2", str(pid), "1", "cuda"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=240)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, out in zip(procs, outputs):
        assert proc.returncode == 0 and "multislice dryrun OK" in out, out
