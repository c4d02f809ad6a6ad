"""Paged-attention inputs shared by the port's kernel tests (numpy only:
the card's test file imports this and must not import jax)."""
import numpy as np

# B, S, h, hk, hd, page_size, W, window -- the reference's GQA_CASES
GQA_CASES = [
    (2, 1, 4, 2, 64, 16, 4, 0),        # decode step, GQA
    (3, 1, 4, 4, 32, 8, 5, 0),         # MHA
    (1, 12, 4, 1, 64, 16, 3, 0),       # prefill chunk, MQA
    (2, 7, 8, 2, 32, 8, 6, 20),        # sliding window
    (2, 5, 2, 2, 64, 32, 2, 0),        # big pages, ragged chunk
]

POISON = 1e4


def paged_case(seed, B, S, h, hk, hd, ps, W, *, lengths=None):
    """Random q, token-major pools and a page table.  Slot b has
    ``lengths[b]`` tokens written (default: a random whole number of
    pages, at least S tokens); its S queries sit at the last S written
    positions.  The trash page 0, every unreferenced page and the
    unwritten tail of each slot's last page hold POISON, so only the
    mask keeps them out of the output."""
    rng = np.random.default_rng(seed)
    if lengths is None:
        lo = -(-S // ps)
        lengths = rng.integers(lo, W + 1, B) * ps
    lengths = np.asarray(lengths)
    n_pages = W * B + 2
    k = np.full((n_pages * ps, hk, hd), POISON, np.float32)
    v = np.full((n_pages * ps, hk, hd), POISON, np.float32)
    table = np.zeros((B, W), np.int32)
    nxt = 1
    for b in range(B):
        for w in range(-(-int(lengths[b]) // ps)):
            table[b, w] = nxt
            n_written = min(ps, int(lengths[b]) - w * ps)
            rows = slice(nxt * ps, nxt * ps + n_written)
            k[rows] = rng.standard_normal((n_written, hk, hd))
            v[rows] = rng.standard_normal((n_written, hk, hd))
            nxt += 1
    q = rng.standard_normal((B, S, h, hd)).astype(np.float32)
    pos = np.stack([np.arange(L - S, L) for L in lengths]).astype(np.int32)
    return q, k, v, table, pos


# B, S, h, r, rope, page_size, W, window -- the reference's MLA_CASES
MLA_CASES = [
    (2, 1, 4, 32, 16, 16, 4, 0),       # decode step
    (1, 9, 4, 32, 16, 8, 5, 0),        # prefill chunk
    (2, 4, 2, 64, 8, 8, 6, 24),        # sliding window
]


def mla_case(seed, B, S, h, r, rope, ps, W, *, lengths=None):
    """Random absorbed-MLA inputs: q_lat (B, S, h, r), q_rope (B, S, h,
    rope), token-major latent and rope-key pools (N, r) and (N, rope),
    a page table and positions, laid out as ``paged_case`` lays out K/V
    (POISON outside the written rows)."""
    rng = np.random.default_rng(seed)
    if lengths is None:
        lo = -(-S // ps)
        lengths = rng.integers(lo, W + 1, B) * ps
    lengths = np.asarray(lengths)
    n_pages = W * B + 2
    ckv = np.full((n_pages * ps, r), POISON, np.float32)
    krope = np.full((n_pages * ps, rope), POISON, np.float32)
    table = np.zeros((B, W), np.int32)
    nxt = 1
    for b in range(B):
        for w in range(-(-int(lengths[b]) // ps)):
            table[b, w] = nxt
            n_written = min(ps, int(lengths[b]) - w * ps)
            rows = slice(nxt * ps, nxt * ps + n_written)
            ckv[rows] = rng.standard_normal((n_written, r))
            krope[rows] = rng.standard_normal((n_written, rope))
            nxt += 1
    q_lat = rng.standard_normal((B, S, h, r)).astype(np.float32)
    q_rope = rng.standard_normal((B, S, h, rope)).astype(np.float32)
    pos = np.stack([np.arange(L - S, L) for L in lengths]).astype(np.int32)
    return q_lat, q_rope, ckv, krope, table, pos
