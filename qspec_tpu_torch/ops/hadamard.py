"""Hadamard matrices and the online Hadamard rotation of QuaRot.

Port of ``qspec_tpu/ops/hadamard.py``. QuaRot applies a scaled Hadamard
transform H_n / sqrt(n) before o_proj (over the heads) and down_proj (over
the intermediate width), with n = K * P and H_n = H_K (x) H_P. Both Kronecker
factors are applied as matmuls (for n = 14336 = 28 * 512: one [*, 512] x
[512, 512] product and one [28, 28] x [28, *] product), which is what the JAX
package does too; the non-power-of-two factors are constructed (Sylvester,
Paley I, Paley II) in numpy, not vendored, and each is checked
H @ H.T == n * I when built. ``random_hadamard_matrix`` is the residual
rotation Q of the offline QuaRot pipeline (``model_loader/loader.py::
quantize_float``), the JAX package's matrix bit for bit for the same seed.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["hadamard_matrix", "decompose_dim", "hadamard_transform",
           "random_hadamard_matrix"]


def _sylvester(k: int) -> np.ndarray:
    h = np.array([[1]], dtype=np.int64)
    while h.shape[0] < k:
        h = np.block([[h, h], [h, -h]])
    assert h.shape[0] == k
    return h


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in range(2, int(math.isqrt(n)) + 1):
        if n % p == 0:
            return False
    return True


def _prime_power(q: int):
    """Return (p, m) with q = p^m if q is a prime power, else None."""
    for p in range(2, int(math.isqrt(q)) + 1):
        if q % p == 0:
            m = 0
            while q % p == 0:
                q //= p
                m += 1
            return (p, m) if q == 1 and _is_prime(p) else None
    return (q, 1) if _is_prime(q) else None


def _gf_elements(p: int, m: int):
    """Multiplication table setup for GF(p^m): returns (elements, mul, add).

    Elements are tuples of coefficients (degree < m) over GF(p); arithmetic is
    polynomial arithmetic modulo an irreducible degree-m polynomial found by
    brute force.
    """
    import itertools

    if m == 1:
        elems = list(range(p))
        return elems, (lambda a, b: (a * b) % p), (lambda a, b: (a + b) % p)

    def polymul_mod(a, b, modpoly):
        # a, b: low-order-first coefficient tuples of length m
        res = [0] * (2 * m - 1)
        for i, ai in enumerate(a):
            if ai:
                for j, bj in enumerate(b):
                    res[i + j] = (res[i + j] + ai * bj) % p
        # reduce by modpoly (monic, degree m, low-order-first, length m+1)
        for d in range(2 * m - 2, m - 1, -1):
            c = res[d]
            if c:
                res[d] = 0
                for j in range(m):
                    res[d - m + j] = (res[d - m + j] - c * modpoly[j]) % p
        return tuple(res[:m])

    def polyadd(a, b):
        return tuple((x + y) % p for x, y in zip(a, b))

    def is_irreducible(modpoly):
        # no roots is necessary but not sufficient for m>3; use full check:
        # irreducible iff no factor of degree <= m//2. Brute-force trial
        # division over all monic polys of degree 1..m//2.
        def poly_mod(dividend, divisor):
            dividend = list(dividend)
            dd, dv = len(dividend) - 1, len(divisor) - 1
            inv = pow(divisor[-1], -1, p)
            for d in range(dd, dv - 1, -1):
                c = (dividend[d] * inv) % p
                if c:
                    for j in range(dv + 1):
                        dividend[d - dv + j] = (dividend[d - dv + j] - c * divisor[j]) % p
            return any(x % p for x in dividend[:dv])

        for deg in range(1, m // 2 + 1):
            for coeffs in itertools.product(range(p), repeat=deg):
                divisor = list(coeffs) + [1]
                if not poly_mod(list(modpoly), divisor):
                    return False
        return True

    modpoly = None
    for coeffs in itertools.product(range(p), repeat=m):
        cand = list(coeffs) + [1]
        if is_irreducible(cand):
            modpoly = cand
            break
    assert modpoly is not None

    elems = list(itertools.product(range(p), repeat=m))
    return elems, (lambda a, b: polymul_mod(a, b, modpoly)), polyadd


def _paley_core(q: int) -> np.ndarray:
    """Jacobsthal-style quadratic-character matrix Q for GF(q), shape [q, q]."""
    p, m = _prime_power(q)
    elems, mul, add = _gf_elements(p, m)
    idx = {e: i for i, e in enumerate(elems)}
    zero = elems[0] if isinstance(elems[0], int) else tuple([0] * m)
    squares = set()
    for e in elems:
        if e != zero:
            squares.add(mul(e, e))

    def neg(e):
        if isinstance(e, int):
            return (-e) % p
        return tuple((-c) % p for c in e)

    Q = np.zeros((q, q), dtype=np.int64)
    for i, a in enumerate(elems):
        for j, b in enumerate(elems):
            d = add(a, neg(b))
            if d == zero:
                chi = 0
            elif d in squares:
                chi = 1
            else:
                chi = -1
            Q[i, j] = chi
    return Q


def _paley1(q: int) -> np.ndarray:
    """Paley construction I: H_{q+1} for prime power q = 3 (mod 4)."""
    Q = _paley_core(q)
    n = q + 1
    H = np.ones((n, n), dtype=np.int64)
    H[1:, 1:] = Q + np.eye(q, dtype=np.int64)
    H[1:, 0] = -1
    return H


def _paley2(q: int) -> np.ndarray:
    """Paley construction II: H_{2(q+1)} for prime power q = 1 (mod 4)."""
    n = q + 1
    S = np.zeros((n, n), dtype=np.int64)
    S[0, 1:] = 1
    S[1:, 0] = 1
    S[1:, 1:] = _paley_core(q)
    H = np.zeros((2 * n, 2 * n), dtype=np.int64)
    # H = S (x) [[1,1],[1,-1]] + I (x) [[1,-1],[-1,-1]]
    A = np.array([[1, 1], [1, -1]], dtype=np.int64)
    Dg = np.array([[1, -1], [-1, -1]], dtype=np.int64)
    for i in range(n):
        for j in range(n):
            blk = S[i, j] * A + (Dg if i == j else 0)
            H[2 * i:2 * i + 2, 2 * j:2 * j + 2] = blk
    return H


@functools.lru_cache(maxsize=None)
def hadamard_matrix(n: int) -> np.ndarray:
    """Return an n x n {+-1} Hadamard matrix (unnormalized), verified."""
    if n == 1:
        return np.array([[1]], dtype=np.int64)
    if n == 2 or n % 4 == 0:
        H = None
        if n & (n - 1) == 0:
            H = _sylvester(n)
        elif _prime_power(n - 1) and (n - 1) % 4 == 3:
            H = _paley1(n - 1)
        elif n % 2 == 0 and _prime_power(n // 2 - 1) and (n // 2 - 1) % 4 == 1:
            H = _paley2(n // 2 - 1)
        else:
            # Composite fallback: n = a*b with both factors constructible.
            for a in range(2, int(math.isqrt(n)) + 1):
                if n % a == 0:
                    try:
                        Ha = hadamard_matrix(a)
                        Hb = hadamard_matrix(n // a)
                        H = np.kron(Ha, Hb)
                        break
                    except NotImplementedError:
                        continue
        if H is not None:
            assert (H @ H.T == n * np.eye(n, dtype=np.int64)).all(), f"bad H_{n}"
            return H
    raise NotImplementedError(f"no Hadamard construction for n={n}")


@functools.lru_cache(maxsize=None)
def decompose_dim(n: int) -> tuple[int, int]:
    """Split n = K * P with P a power of two <= 512 and K constructible.

    The same split as the JAX package, so both rotate with identical factor
    matrices. P is capped at 512 so the dense factors stay small (a pure
    power-of-two n would otherwise materialize an n x n Sylvester matrix;
    H_{2^a} (x) H_{2^b} is the same transform at a fraction of the bytes).
    """
    k = 0
    K = n
    while K % 2 == 0 and n // K < 512:
        K //= 2
        k += 1
    # fold 2s back into K while K itself has no construction
    while True:
        try:
            hadamard_matrix(K)
            return K, n // K
        except NotImplementedError:
            if k == 0:
                raise
            K *= 2
            k -= 1


def hadamard_transform(x: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """Apply (H_K (x) H_P) * scale along the last dim (n = K * P), in f32.

    Default scale is 1/sqrt(n) (orthonormal).
    """
    n = x.shape[-1]
    K, P = decompose_dim(n)
    hK = torch.as_tensor(hadamard_matrix(K), dtype=torch.float32, device=x.device)
    hP = torch.as_tensor(hadamard_matrix(P), dtype=torch.float32, device=x.device)
    if scale is None:
        scale = 1.0 / math.sqrt(n)
    xf = x.to(torch.float32).reshape(x.shape[:-1] + (K, P))
    xf = torch.einsum("...kp,pq->...kq", xf, hP)
    if K > 1:
        xf = torch.einsum("jk,...kp->...jp", hK, xf)
    return (xf.reshape(x.shape) * scale).to(x.dtype)


def random_hadamard_matrix(n: int, seed: int = 0) -> np.ndarray:
    """Randomized orthonormal Hadamard Q = H_n * diag(+-1) / sqrt(n), float64
    (``qspec_tpu/ops/hadamard.py::random_hadamard_matrix``: the same numpy
    generator draws the same signs, and the same Kronecker factors give the
    same H_n)."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2, size=n) * 2 - 1
    K, P = decompose_dim(n)
    H = np.kron(hadamard_matrix(K), hadamard_matrix(P)).astype(np.float64)
    return (H * d[None, :]) / math.sqrt(n)


def hadamard_f32(n: int, device) -> torch.Tensor:
    """(H_K (x) H_P) / sqrt(n) in float32, n = K * P (decompose_dim), made
    on ``device``: the JAX ``quantize_float``'s dense H_I (np.kron, then
    float32, then the float32 division) value for value."""
    K, P = decompose_dim(n)
    f32 = dict(dtype=torch.float32, device=device)
    h = torch.kron(torch.as_tensor(hadamard_matrix(K), **f32),
                   torch.as_tensor(hadamard_matrix(P), **f32))
    return h / torch.tensor(math.sqrt(n), **f32)
