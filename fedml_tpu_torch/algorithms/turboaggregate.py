"""TurboAggregate: secure aggregation through finite-field MPC
(counterpart of ``fedml_tpu/algorithms/turboaggregate.py``; reference
fedml_api/standalone/turboaggregate/, mpc_function.py:62-260 around the
FedAvg round loop of TA_trainer.py:39-72).

The field arithmetic is the JAX package's numpy, copied as written and
bit-equal to it on the same inputs and generator: vectorized int64 over the
prime field p = 2^31 - 1 (products stay below 2^62), Fermat inverses,
Lagrange coefficients, BGW (Shamir) and Lagrange-coded sharing, additive
shares and fixed-point quantization with ``frac_bits`` fractional bits.

:class:`TurboAggregateAPI` trains the cohort as FedAvg's host round does,
then aggregates on the host: each client's update, in the JAX package's
flat leaf order (``models/convert.flax_leaf_order``), is scaled by its
weight ``count / sum(counts)`` (f64), quantized into the field, shared
additively within its group, relayed along the group ring, and only the
total is dequantized (``secure_weighted_sum``, seeded by the round's total
count). The field holds ``|x * w| < (p - 1) / 2 / 2^frac_bits`` (about 1024
at 20 bits); larger values wrap, in the JAX package and here alike.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Sequence

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, OwnRoundMixin
from fedml_tpu_torch.models.convert import flax_leaf_order

log = logging.getLogger(__name__)

P_DEFAULT = np.int64(2**31 - 1)


def _require_rng(rng) -> np.random.Generator:
    """Every masking or share draw comes from a caller-seeded generator
    (OS-entropy shares would make runs irreproducible). Accepts a
    Generator, or a seed (int or sequence) to derive one from."""
    if rng is None:
        raise ValueError(
            "rng is required: pass a np.random.Generator derived from the "
            "run seed (or the seed itself) — OS-entropy shares break run "
            "determinism"
        )
    if isinstance(rng, np.random.Generator):
        return rng
    return np.random.default_rng(rng)


# ---------------------------------------------------------------- field ops

def modpow(base: np.ndarray, exp: int, p: np.int64) -> np.ndarray:
    """Vectorized modular exponentiation (square-and-multiply). Safe because
    p < 2^31 keeps every product below 2^62 < int64 max."""
    result = np.ones_like(np.asarray(base, dtype=np.int64))
    b = np.mod(np.asarray(base, dtype=np.int64), p)
    e = int(exp)
    while e > 0:
        if e & 1:
            result = np.mod(result * b, p)
        b = np.mod(b * b, p)
        e >>= 1
    return result


def modular_inv(a: np.ndarray, p: np.int64 = P_DEFAULT) -> np.ndarray:
    """Fermat: a^(p-2) mod p (p prime) — vectorized replacement for the
    reference's scalar extended-Euclid loop (mpc_function.py:4-18)."""
    return modpow(a, int(p) - 2, p)


def lagrange_coeffs(
    alphas: np.ndarray, betas: np.ndarray, p: np.int64 = P_DEFAULT
) -> np.ndarray:
    """U[i, j] = prod_{k!=j}(alpha_i - beta_k) / prod_{k!=j}(beta_j - beta_k)
    mod p (mpc_function.py:38-57), computed with outer products."""
    alphas = np.mod(np.asarray(alphas, np.int64), p)
    betas = np.mod(np.asarray(betas, np.int64), p)
    A, B = len(alphas), len(betas)
    # num[i, j] = prod over k != j of (alpha_i - beta_k)
    diff_ab = np.mod(alphas[:, None] - betas[None, :], p)        # [A, B]
    num = np.ones((A, B), np.int64)
    den = np.ones((B,), np.int64)
    diff_bb = np.mod(betas[:, None] - betas[None, :], p)         # [B, B]
    for k in range(B):
        mask = np.arange(B) != k
        num[:, mask] = np.mod(num[:, mask] * diff_ab[:, k][:, None], p)
        den[mask] = np.mod(den[mask] * diff_bb[mask, k], p)
    return np.mod(num * modular_inv(den, p)[None, :], p)


# ------------------------------------------------------- BGW secret sharing

def bgw_encode(
    X: np.ndarray, N: int, T: int, p: np.int64 = P_DEFAULT,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Shamir/BGW: degree-T polynomial with constant term X evaluated at
    alpha_1..alpha_N (mpc_function.py:62-76). X [m, d] -> shares [N, m, d]."""
    rng = _require_rng(rng)
    X = np.mod(np.asarray(X, np.int64), p)
    coeffs = rng.integers(0, int(p), size=(T + 1,) + X.shape, dtype=np.int64)
    coeffs[0] = X
    alphas = np.arange(1, N + 1, dtype=np.int64)
    shares = np.zeros((N,) + X.shape, np.int64)
    for i in range(N):
        a_pow = np.int64(1)
        for t in range(T + 1):
            shares[i] = np.mod(shares[i] + coeffs[t] * a_pow, p)
            a_pow = np.mod(a_pow * alphas[i], p)
    return shares


def bgw_decode(
    shares: np.ndarray, worker_idx: Sequence[int], p: np.int64 = P_DEFAULT
) -> np.ndarray:
    """Reconstruct the secret from >=T+1 shares by Lagrange interpolation at
    0 (mpc_function.py:79-108). The degree-T polynomial needs T+1 points;
    fewer would interpolate a lower-degree polynomial through the wrong
    value — callers must know reconstruction failed, not get garbage."""
    worker_idx = np.asarray(worker_idx)
    if shares.shape[0] != len(worker_idx):
        raise ValueError("one share per worker index required")
    alphas = np.mod(worker_idx + 1, p).astype(np.int64)   # alpha_i = i + 1
    lam = lagrange_coeffs(np.zeros(1, np.int64), alphas, p)[0]   # [R]
    flat = shares.reshape(len(worker_idx), -1)
    out = np.zeros(flat.shape[1], np.int64)
    for r in range(len(worker_idx)):
        out = np.mod(out + lam[r] * flat[r], p)
    return out.reshape(shares.shape[1:])


# ------------------------------------------------ Lagrange-coded computing

def _lcc_points(N: int, K: int, T: int, p: np.int64):
    """Interpolation points (betas) and evaluation points (alphas). The
    reference centers BOTH ranges near 0 (mpc_function.py:124-126), which
    makes some alphas coincide with data betas — those workers then receive
    raw secret chunks in the clear, voiding the T-colluder privacy. We keep
    the reference's betas but place alphas in a disjoint range (a reference
    defect fixed, not replicated)."""
    n_beta = K + T
    stt_b = -int(np.floor(n_beta / 2))
    betas = np.mod(np.arange(stt_b, stt_b + n_beta), p).astype(np.int64)
    stt_a = stt_b + n_beta  # first point past the beta range
    alphas = np.mod(np.arange(stt_a, stt_a + N), p).astype(np.int64)
    return alphas, betas


def lcc_encode(
    X: np.ndarray, N: int, K: int, T: int, p: np.int64 = P_DEFAULT,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Split X [m, d] into K chunks + T random chunks, interpolate through
    them, evaluate at N points (mpc_function.py:111-134). Returns
    [N, m//K, d]."""
    rng = _require_rng(rng)
    X = np.mod(np.asarray(X, np.int64), p)
    m = X.shape[0]
    assert m % K == 0, "rows must divide evenly into K chunks"
    chunks = X.reshape(K, m // K, *X.shape[1:])
    if T:
        noise = rng.integers(0, int(p), size=(T,) + chunks.shape[1:], dtype=np.int64)
        chunks = np.concatenate([chunks, noise], axis=0)
    alphas, betas = _lcc_points(N, K, T, p)
    U = lagrange_coeffs(alphas, betas, p)                 # [N, K+T]
    flat = chunks.reshape(K + T, -1)
    out = np.zeros((N, flat.shape[1]), np.int64)
    for j in range(K + T):
        out = np.mod(out + U[:, j][:, None] * flat[j][None, :], p)
    return out.reshape((N,) + chunks.shape[1:])


def lcc_decode(
    f_eval: np.ndarray, N: int, K: int, T: int, worker_idx: Sequence[int],
    p: np.int64 = P_DEFAULT,
) -> np.ndarray:
    """Interpolate the chunk values back from evaluations at the surviving
    workers' points (mpc_function.py:197-213). For degree-1 (identity)
    computations any K+T workers suffice — and no fewer: the encoding
    polynomial has degree K+T-1."""
    if len(worker_idx) < K + T:
        raise ValueError(
            f"LCC reconstruction needs >= K+T = {K + T} shares, got {len(worker_idx)}"
        )
    alphas, betas = _lcc_points(N, K, T, p)
    eval_pts = alphas[np.asarray(worker_idx)]
    U = lagrange_coeffs(betas[:K], eval_pts, p)           # [K, R]
    flat = f_eval.reshape(len(worker_idx), -1)
    out = np.zeros((K, flat.shape[1]), np.int64)
    for r in range(len(worker_idx)):
        out = np.mod(out + U[:, r][:, None] * flat[r][None, :], p)
    return out.reshape((K,) + f_eval.shape[1:])


def additive_shares(
    x: np.ndarray, n_out: int, p: np.int64 = P_DEFAULT,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """n_out shares summing to x mod p (mpc_function.py:216-226)."""
    rng = _require_rng(rng)
    x = np.mod(np.asarray(x, np.int64), p)
    shares = rng.integers(0, int(p), size=(n_out - 1,) + x.shape, dtype=np.int64)
    last = np.mod(x - np.sum(np.mod(shares, p), axis=0), p)
    return np.concatenate([shares, last[None]], axis=0)


# ------------------------------------------------- fixed-point quantization

def quantize(x: np.ndarray, frac_bits: int = 20, p: np.int64 = P_DEFAULT) -> np.ndarray:
    """float -> field: round(x * 2^frac_bits) with negatives wrapped mod p."""
    scaled = np.rint(np.asarray(x, np.float64) * (1 << frac_bits)).astype(np.int64)
    return np.mod(scaled, p)


def dequantize(
    f: np.ndarray, frac_bits: int = 20, p: np.int64 = P_DEFAULT
) -> np.ndarray:
    """field -> float, interpreting values above p/2 as negatives."""
    f = np.asarray(f, np.int64)
    signed = np.where(f > int(p) // 2, f - int(p), f)
    return signed.astype(np.float64) / (1 << frac_bits)


def secure_weighted_sum(
    vectors: np.ndarray, weights: np.ndarray, group_size: int = 2,
    frac_bits: int = 20, p: np.int64 = P_DEFAULT, seed: int = 0,
) -> np.ndarray:
    """Turbo-Aggregate round: clients pre-scale their update by its weight,
    quantize into the field, additively share WITHIN their group, groups
    relay masked partial sums along the group ring, and only the final total
    leaves the field. No individual update is ever visible in the clear —
    each hop sees field-uniform masked sums only.

    vectors [C, D] float, weights [C] (sum to 1 for a weighted mean).
    Returns the aggregate [D] float.
    """
    rng = np.random.default_rng(seed)
    C, D = vectors.shape
    n_groups = max(1, C // group_size)
    field_total = np.zeros(D, np.int64)
    for g in range(n_groups):
        members = range(g, C, n_groups)  # round-robin grouping
        group_sum = np.zeros(D, np.int64)
        for c in members:
            q = quantize(vectors[c] * weights[c], frac_bits, p)
            shares = additive_shares(q, group_size, p, rng)
            # every member accumulates its share; the in-field sum of the
            # group's shares equals the group's quantized contribution
            group_sum = np.mod(group_sum + np.sum(shares, axis=0) % p, p)
        # ring relay: the running total is itself masked (share sums are
        # uniform until the final unmasking)
        field_total = np.mod(field_total + group_sum, p)
    return dequantize(field_total, frac_bits, p)


class TurboAggregateAPI(OwnRoundMixin, FedAvgAPI):
    """FedAvg whose aggregation is the secure MPC path (TA_trainer.py:39-72).
    Local training is FedAvg's (every live step a replay of the captured
    step); the protocol runs on the host over the quantized flat updates.
    The round is the algorithm's own (``fedavg.OwnRoundMixin``), as in the
    JAX package, which overrides ``build_round_step``. ``mpc_stats`` holds
    the last round's host MPC time, its largest ``|x * w|`` and total beside
    the field's limit, and the floats that wrapped."""

    def __init__(self, dataset, config, bundle=None, group_size: int = 2, frac_bits: int = 20,
                 **kw):
        self.group_size = group_size
        self.frac_bits = frac_bits
        self.mpc_stats: Optional[dict] = None
        self.wrapped: dict = {}
        super().__init__(dataset, config, bundle, **kw)

    def _plain_round(self, round_idx: int, cx, cy, cm, counts: np.ndarray,
                     wn: np.ndarray) -> "float | torch.Tensor":
        results = self._train_clients(round_idx, range(len(counts)), cx, cy, cm, counts)
        w = torch.as_tensor(wn, dtype=torch.float32, device=self.device)
        train_loss = (torch.stack([r.train_loss for r in results]) * w).sum() / w.sum()
        self.variables = self.secure_aggregate([r.variables for r in results], wn)
        return train_loss if self.config.async_rounds else float(train_loss)

    def secure_aggregate(self, client_vars: Sequence[dict], wn: np.ndarray) -> dict:
        """The clients' weighted mean through ``secure_weighted_sum``: the
        flat f64 updates in the JAX package's leaf order, the weights
        ``wn / sum(wn)`` in f64, the MPC seeded by ``int(sum(wn))``; each
        leaf cast back to its dtype on the API's device. A float whose
        quantized total leaves the field (``|sum_c x_c * w_c|`` past about
        ``(p - 1) / 2 / 2^frac_bits``) comes back wrapped, as in the JAX
        package: ``mpc_stats`` counts such floats and names their leaves,
        ``wrapped`` holds their masks, and a warning says so."""
        t0 = time.perf_counter()
        names = flax_leaf_order(self.variables)
        C = len(client_vars)
        flat = np.concatenate(
            [torch.stack([v[k] for v in client_vars]).to(torch.float64).reshape(C, -1)
             .cpu().numpy() for k in names], axis=1)
        w = np.asarray(wn, np.float64)
        w = w / w.sum()
        agg = secure_weighted_sum(flat, w, self.group_size, self.frac_bits,
                                  seed=int(np.sum(wn)))
        mpc_ms = (time.perf_counter() - t0) * 1e3
        # the total the field had to hold, exactly: a float wrapped where
        # the dequantized aggregate is not it
        xw = flat * w[:, None]
        scale = float(1 << self.frac_bits)
        exact = np.rint(xw * scale).astype(np.int64).sum(axis=0) / scale
        out, self.wrapped, off = {}, {}, 0
        for k in names:
            ref = self.variables[k]
            sl = slice(off, off + ref.numel())
            out[k] = torch.from_numpy(agg[sl].reshape(ref.shape)).to(device=self.device,
                                                                       dtype=ref.dtype)
            bad = agg[sl] != exact[sl]
            if bad.any():
                self.wrapped[k] = torch.from_numpy(bad.reshape(ref.shape))
            off += ref.numel()
        limit = (int(P_DEFAULT) - 1) / 2 / scale
        self.mpc_stats = {"mpc_ms": mpc_ms, "max_abs_xw": float(np.abs(xw).max()),
                          "max_abs_total": float(np.abs(exact).max()), "field_limit": limit,
                          "floats": int(flat.shape[1]), "clients": C,
                          "wrapped_floats": int(sum(int(m.sum()) for m in self.wrapped.values())),
                          "wrapped_leaves": list(self.wrapped)}
        if self.wrapped:
            log.warning("TurboAggregate: %d floats of %s wrapped: their totals reach %.6g, past "
                        "the field's %.6g at frac_bits=%d", self.mpc_stats["wrapped_floats"],
                        list(self.wrapped), self.mpc_stats["max_abs_total"], limit,
                        self.frac_bits)
        return {k: out[k] for k in self.variables}
