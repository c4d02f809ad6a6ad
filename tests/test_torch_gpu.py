"""The port on the card: the CUDA paged flash-decode kernel against its
plain PyTorch version, the launch counter, and greedy serving on the
card against the CPU.  Marked ``gpu``; each test skips by itself where
no card is present.  Imports no jax (the card's machine has none).

Run on a machine with an H100:  PYTHONPATH=src pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from torch_paged_cases import GQA_CASES, POISON, paged_case

from repro_torch.configs import smoke_config
from repro_torch.kernels import (launch_counts, paged_flash_decode,
                                 paged_flash_decode_ref, reset_launch_counts)
from repro_torch.models import init_model
from repro_torch.serve import ContinuousScheduler

pytestmark = pytest.mark.gpu

# fp32: the reference's own kernel bar (tests/test_paged_decode.py).
# bf16: 8-bit mantissa (eps 7.8e-3); the plain version also rounds the
# probabilities to bf16 before the value product, the kernel does not.
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

FULL_WIDTH_CASES = [
    # B, S, h, hk, hd, page_size, W, window  (qwen3-1.7b widths)
    (8, 1, 16, 8, 128, 16, 37, 0),     # decode over 8 slots
    (1, 32, 16, 8, 128, 16, 37, 0),    # prefill chunk
    (4, 32, 16, 8, 128, 16, 37, 100),  # windowed chunk: masked pages first
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, dtype, q, k, v, table, pos):
    return (torch.from_numpy(q).to(dev, dtype), torch.from_numpy(k).to(dev, dtype),
            torch.from_numpy(v).to(dev, dtype), torch.from_numpy(table).to(dev),
            torch.from_numpy(pos).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GQA_CASES + FULL_WIDTH_CASES)
def test_kernel_matches_plain(cuda, case, dtype):
    B, S, h, hk, hd, ps, W, window = case
    lengths = None
    if (B, S) == (8, 1):           # mixed slot lengths, 1 token .. max_len
        lengths = np.linspace(1, W * ps, B).astype(int)
    args = _on(cuda, dtype, *paged_case(sum(case), B, S, h, hk, hd, ps, W,
                                        lengths=lengths))
    got = paged_flash_decode(*args, page_size=ps, window=window)
    want = paged_flash_decode_ref(*args, page_size=ps, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_kernel_trash_poison_never_leaks(cuda):
    """Poisoned trash/unwritten storage gives the bitwise same output as
    zero-filled storage: visibility alone isolates it."""
    case = (2, 3, 4, 2, 32, 8, 4)
    q, k, v, table, pos = paged_case(5, *case)
    clean_k, clean_v = (np.where(x == POISON, 0.0, x).astype(np.float32)
                        for x in (k, v))
    big_k, big_v = (np.where(x == POISON, 1e8, x).astype(np.float32)
                    for x in (k, v))
    a = paged_flash_decode(*_on(cuda, torch.float32, q, clean_k, clean_v, table,
                                pos), page_size=8)
    b = paged_flash_decode(*_on(cuda, torch.float32, q, big_k, big_v, table,
                                pos), page_size=8)
    assert torch.equal(a, b)


def test_kernel_counts_launches_and_rejects_bad_input(cuda):
    args = _on(cuda, torch.float32, *paged_case(1, 2, 1, 4, 2, 64, 16, 4))
    reset_launch_counts()
    paged_flash_decode(*args, page_size=16)
    paged_flash_decode(*args, page_size=16)
    assert launch_counts()["paged_flash_decode"] == 2
    q, k, v, table, pos = args
    with pytest.raises(TypeError):
        paged_flash_decode(q, k.half(), v.half(), table, pos, page_size=16)
    with pytest.raises(TypeError):
        paged_flash_decode(q, k, v, table.long(), pos, page_size=16)
    assert launch_counts()["paged_flash_decode"] == 2


def test_greedy_serving_on_card_matches_cpu(cuda):
    """The smoke config in fp32: greedy tokens through the kernel on the
    card equal the plain path on the CPU, and every attention call of
    the run launched the kernel."""
    cfg = smoke_config("qwen3-1.7b").with_overrides(dtype="float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 40, 19)]
    outs = {}
    for dev in ("cpu", "cuda"):
        model = init_model(cfg, seed=0, device="cpu")
        if dev == "cuda":
            model = model.to(cuda)
        sch = ContinuousScheduler(cfg, model, slots=2, max_len=96,
                                  page_size=16, decode_chunk=4)
        reset_launch_counts()
        outs[dev] = sch.generate(prompts, 12)
        st = sch.stats()
    calls = st["prefill_dispatches"] + st["decode_dispatches"] * 4
    assert launch_counts()["paged_flash_decode"] == cfg.num_layers * calls
    for a, b in zip(outs["cpu"], outs["cuda"]):
        np.testing.assert_array_equal(a, b)
