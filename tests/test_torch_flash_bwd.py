"""The flash backward's plain versions on the CPU: the kernels' algorithm
(``flash_attention_bwd_tiled``: FlashAttention-2 from the forward's row
log-sum-exp, the kernels' tile schedule and rounding) against
``jax.grad`` of the reference's ``chunked_attention`` at every width
pair the kernels are built for, causal, windowed and non-causal with S
!= T, at group sizes 1, 2 and 3; the log-sum-exp the forward writes
(``flash_attention_lse_ref``) against ``torch.logsumexp`` of the masked
scaled scores; and the schedule (``bwd_rows``, ``bwd_keys``,
``bwd_unit_state``) against a brute-force mask.  The CUDA kernels run
only on the card (``tests/test_torch_gpu.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import chunked_attention as jax_chunked
from repro_torch.kernels.flash_attention import (
    BWD_UNIT, KERNEL_WIDTHS, bwd_keys, bwd_rows, bwd_unit_state,
    flash_attention_bwd, flash_attention_bwd_tiled, flash_attention_lse_ref,
    flash_attention_ref)

torch.set_num_threads(2)

# the reference's fp32 gradient bar for the plain backward
# (tests/test_torch_flash_attention.py's width cases): max |err| within
# 1e-5 of max |grad|
GRAD_RTOL = 1e-5
# tiles small enough that a 64-row call has several, with the kernel's
# ratio (a row tile half its key block)
SMALL_TILES = {"kv_keys": 32, "kv_rows": 16}

FORMS = [
    # name, S, T, causal, window
    ("causal", 48, 48, True, 0),
    ("right-aligned", 29, 64, True, 0),
    ("windowed", 40, 56, True, 11),
    ("non-causal S>T", 50, 23, False, 0),
]
# every width pair, each at every form; g cycles through 1, 2, 3 so that
# each width and each form meets more than one group size
CASES = [(w, f, 1 + (i + j) % 3) for i, w in enumerate(KERNEL_WIDTHS)
         for j, f in enumerate(FORMS)]


def _case_id(case):
    (hd, hdv), form, g = case
    return f"{hd}x{hdv}-{form[0]}-g{g}"


def _inputs(seed, B, S, T, h, hk, hd, hdv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, h, hd)).astype(np.float32),
            rng.standard_normal((B, T, hk, hd)).astype(np.float32),
            rng.standard_normal((B, T, hk, hdv)).astype(np.float32),
            rng.standard_normal((B, S, h, hdv)).astype(np.float32))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_tiled_backward_matches_reference_grad(case):
    """flash_attention_bwd_tiled (from the plain forward's output and
    log-sum-exp) against jax.grad of the reference's chunked_attention,
    within 1e-5 x max |grad| for dq, dk and dv."""
    (hd, hdv), (_, S, T, causal, window), g = case
    B, hk = 1, 2
    h = g * hk
    q, k, v, dout = _inputs(hd + S + g, B, S, T, h, hk, hd, hdv)

    # the reference treats a negative position as a padding row; without a
    # causal or window mask the positions do not matter, so S > T takes 0..
    q_pos = jnp.arange(S) + (T - S if causal or window else 0)

    def jfwd(q, k, v):
        return jax_chunked(q, k, v, q_positions=q_pos,
                           kv_positions=jnp.arange(T), causal=causal,
                           window=window, chunk=16)

    want = jax.grad(lambda *a: jnp.sum(jfwd(*a) * dout), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out = flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    lse = flash_attention_lse_ref(tq, tk, causal=causal, window=window)
    got = flash_attention_bwd_tiled(tq, tk, tv, out, lse, tdo, causal=causal,
                                    window=window, tiles=SMALL_TILES)
    for name, a, w in zip("qkv", got, want):
        w = np.asarray(w)
        assert a.shape == w.shape and a.dtype == torch.float32, name
        assert np.abs(a.numpy() - w).max() <= GRAD_RTOL * np.abs(w).max(), name


# the kernel's own tiles (128-key blocks, 64-row tiles; 32 at MLA's
# widths) at their edges: T one past a key block, several key blocks
# adding to one row tile in turn, g S not a multiple of the row tile and
# g 3 (a tile's rows span positions), causal, windowed, non-causal
EDGES = [
    # hd, hdv, S, T, g, causal, window
    (64, 64, 129, 129, 3, True, 0),
    (64, 64, 40, 129, 2, False, 0),
    (128, 128, 70, 260, 3, True, 150),
    (192, 128, 50, 129, 1, True, 0),
    (192, 128, 33, 140, 3, False, 20),
]


@pytest.mark.parametrize("edge", EDGES, ids=str)
def test_tiled_backward_at_kernel_tile_edges(edge):
    """flash_attention_bwd_tiled at the kernel's default tiles against
    jax.grad of the reference's chunked_attention, within 1e-5 x max
    |grad|, where the key blocks and row tiles end ragged."""
    hd, hdv, S, T, g, causal, window = edge
    B, hk = 1, 2
    q, k, v, dout = _inputs(S + T + g, B, S, T, g * hk, hk, hd, hdv)
    q_pos = jnp.arange(S) + (T - S if causal or window else 0)

    def jfwd(q, k, v):
        return jax_chunked(q, k, v, q_positions=q_pos,
                           kv_positions=jnp.arange(T), causal=causal,
                           window=window, chunk=32)

    want = jax.grad(lambda *a: jnp.sum(jfwd(*a) * dout), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out = flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    lse = flash_attention_lse_ref(tq, tk, causal=causal, window=window)
    got = flash_attention_bwd_tiled(tq, tk, tv, out, lse, tdo, causal=causal,
                                    window=window)
    for name, a, w in zip("qkv", got, want):
        w = np.asarray(w)
        assert a.shape == w.shape, name
        assert np.abs(a.numpy() - w).max() <= GRAD_RTOL * np.abs(w).max(), name


def test_wrapper_takes_the_tiled_version_on_cpu_and_checks_shapes():
    """flash_attention_bwd on CPU tensors is the tiled version (its
    default tiles, the bf16 kernels'), and it refuses an lse or an output
    gradient of the wrong shape."""
    B, S, T, h, hk, hd = 1, 70, 70, 4, 2, 64
    q, k, v, dout = map(torch.from_numpy, _inputs(3, B, S, T, h, hk, hd, hd))
    out = flash_attention_ref(q, k, v, window=20)
    lse = flash_attention_lse_ref(q, k, window=20)
    got = flash_attention_bwd(q, k, v, out, lse, dout, window=20)
    want = flash_attention_bwd_tiled(q, k, v, out, lse, dout, window=20)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, out, lse[:, :, 1:], dout)
    with pytest.raises(ValueError, match="dout"):
        flash_attention_bwd(q, k, v, out, lse, dout[:, 1:])
    with pytest.raises(ValueError, match="see no key"):
        flash_attention_bwd(q, k[:, :9], v[:, :9], out, lse, dout)


@pytest.mark.parametrize("form", FORMS + [("non-causal windowed", 30, 21,
                                           False, 4)], ids=lambda f: f[0])
def test_lse_matches_logsumexp_of_masked_scores(form):
    """The forward's log-sum-exp: each row's torch.logsumexp over the
    scaled scores of exactly the keys it sees, found by brute force."""
    _, S, T, causal, window = form
    B, h, hk, hd = 2, 6, 2, 24
    q, k, _, _ = map(torch.from_numpy, _inputs(S * T, B, S, T, h, hk, hd, hd))
    got = flash_attention_lse_ref(q, k, causal=causal, window=window)
    assert got.shape == (B, h, S) and got.dtype == torch.float32
    scale = 1 / np.sqrt(hd)
    for b in range(B):
        for head in range(h):
            s = q[b, :, head].double() @ k[b, :, head // (h // hk)].double().T
            for i in range(S):
                pos = i + T - S
                keys = [t for t in range(T)
                        if (not causal or t <= pos)
                        and (not window or t > pos - window)]
                want = torch.logsumexp(s[i, keys] * scale, dim=0)
                assert abs(got[b, head, i].item() - want.item()) <= 2e-6 * (
                    1 + abs(want.item())), (b, head, i)


SCHEDULES = [
    # S, T, g, causal, window
    (64, 64, 1, True, 0),
    (40, 100, 2, True, 0),
    (77, 77, 3, True, 19),
    (50, 23, 2, False, 0),
    (33, 70, 1, False, 9),
    (16, 300, 48, True, 0),
    (130, 130, 2, True, 1),
]


def _visible(S, T, g, causal, window):
    """(g S, T) brute-force visibility of position-major rows."""
    vis = np.zeros((g * S, T), bool)
    for r in range(g * S):
        pos = r // g + T - S
        for t in range(T):
            vis[r, t] = ((not causal or t <= pos)
                         and (not window or t > pos - window))
    return vis


@pytest.mark.parametrize("sched", SCHEDULES, ids=str)
def test_schedule_matches_brute_force_mask(sched):
    """Every 16-row x 16-key unit's state is what its visible pairs say
    (no visible pair skipped, no fully masked unit visited, no partly
    masked unit left unmasked), and the row and key ranges of every block
    of 16, 32 and 64 are exactly the rows / keys with a visible pair."""
    S, T, g, causal, window = sched
    vis = _visible(S, T, g, causal, window)
    R, U = g * S, BWD_UNIT
    for r0 in range(0, R, U):
        for k0 in range(0, T, U):
            unit = vis[r0:r0 + U, k0:k0 + U]
            want = 0 if not unit.any() else 1 if unit.all() else 2
            assert bwd_unit_state(r0, min(r0 + U, R), k0, min(k0 + U, T), S,
                                  T, g, causal, window) == want, (r0, k0)
    for block in (16, 32, 64):
        for k0 in range(0, T, block):
            seen = np.flatnonzero(vis[:, k0:k0 + block].any(axis=1))
            want = (seen[0], seen[-1] + 1) if seen.size else (0, 0)
            assert bwd_rows(k0, min(k0 + block, T), S, T, g, causal,
                            window) == want, ("rows", k0)
            assert seen.size == 0 or seen.size == want[1] - want[0]
        for r0 in range(0, R, block):
            seen = np.flatnonzero(vis[r0:r0 + block].any(axis=0))
            want = (seen[0], seen[-1] + 1) if seen.size else (0, 0)
            assert bwd_keys(r0, min(r0 + block, R), S, T, g, causal,
                            window) == want, ("keys", r0)
            assert seen.size == 0 or seen.size == want[1] - want[0]


def test_dq_kernel_probe_is_its_own_library_and_needs_the_card(monkeypatch):
    """The other dQ design's build (``-DFLASH_BWD_OTHER_DQ``, timed by
    ``launch.probe_flash_bwd``) builds under another name than the
    shipped backward, switching it off returns to the shipped build, and
    the probe refuses to run without the card."""
    from repro_torch.kernels import build
    from repro_torch.launch import probe_flash_bwd
    stem = probe_flash_bwd.STEM
    shipped = build._paths(stem)[1]
    assert not any("FLASH_BWD_OTHER_DQ" in f for f in build._flags(stem))
    build.set_probe(stem, True, probe_flash_bwd.MACRO)
    try:
        assert "-DFLASH_BWD_OTHER_DQ" in build._flags(stem)
        assert build._paths(stem)[1] != shipped
    finally:
        build.set_probe(stem, False)
    assert build._paths(stem)[1] == shipped
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="card"):
        probe_flash_bwd.main([])
