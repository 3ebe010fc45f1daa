"""Test-matrix generation library (``slate_matgen`` analogue), in PyTorch.

Reference analogue: ``matgen/`` — ``slate::generate_matrix`` with ~40 named
matrix kinds, singular-/eigen-spectrum control via ``--cond`` and distribution
suffixes, scaling and modifier suffixes, and a counter-based RNG so that any tile
can be generated independently (matgen/random.cc,
matgen/generate_matrix_utils.cc:70-95, public API matgen/generate_matrix.hh:30-71).

Entries are functions of the *global* index: index grids for the deterministic
kinds, and a counter-based threefry2x32 stream keyed per canonical 256x256 block
for the random kinds, so :func:`generate_tile` builds any aligned sub-block without
the rest of the matrix.  The stream is JAX's threefry2x32 (``PRNGKey``,
``fold_in``, ``split`` and the bits of ``uniform``/``normal``/``bernoulli``/
``rademacher``, partitionable layout) rebuilt on int64 tensors, so a seed gives
the same matrix here as in the JAX package: bit for bit for the deterministic and
uniform-family kinds, and within a few ulp for ``randn`` (``erfinv`` is rounded
by a different implementation).  Helpers follow JAX's 64-bit mode, the mode with
float64 (``bernoulli(key, 0.5)`` draws float64 uniforms there).
Spectrum-controlled kinds (svd/heev/poev/diag) build A = U.Sigma.V^H from the
requested sigma distribution, with U, V from the QR of a Gaussian block.

New data goes on ``cuda`` unless ``device=`` is given (the port's entry-point
rule); results are tensors.

Kind grammar (matching the reference's ``--matrix`` strings)::

    <base>[_<dist>][_<scale>][_dominant][_zerocol<N|frac>]

base: zeros ones identity ij jordan jordanT chebspec circul fiedler gfpp kms orthog
      riemann ris zielkeNS minij hilb frank lehmer lotkin redheff triw pei tridiag
      toeppen parter moler cauchy chow clement gcdmat
      rand rands randn randb randr
      diag svd poev spd heev syev
dist (for diag/svd/poev/heev): logrand (default) arith geo cluster0 cluster1
      rarith rgeo rcluster0 rcluster1 specified rand rands randn
scale: ufl ofl small large
"""

from __future__ import annotations

import math
import re
from typing import Optional, Tuple

import numpy as np
import torch

from .core.exceptions import SlateError
from .core.matrix import resolve_device, torch_dtype

__all__ = [
    "generate_matrix", "generate_sigma", "generate_tile", "matrix_kinds",
    "generate_matrix_usage",
]

# canonical random-generation block: random kinds are generated per aligned
# (_GEN_NB x _GEN_NB) block with a key folded by the block index, so any block is
# reproducible in isolation (the reference's counter-based-RNG property)
_GEN_NB = 256
# threefry words drawn per pass of the block-row loop: bounds each int64
# temporary at 2^24 words (128 MiB) whatever the matrix size
_CHUNK_WORDS = 1 << 24

_DETERMINISTIC = (
    "zeros ones identity ij jordan jordanT chebspec circul fiedler gfpp kms orthog "
    "riemann ris zielkeNS minij hilb frank lehmer lotkin redheff triw pei tridiag "
    "toeppen parter moler cauchy chow clement gcdmat"
).split()
_RANDOM = "rand rands randn randb randr".split()
_SPECTRUM = "diag svd poev spd heev syev".split()
_DISTS = ("logrand arith geo cluster0 cluster1 rarith rgeo rcluster0 rcluster1 "
          "specified rand rands randn").split()


def matrix_kinds() -> list:
    """All base kind names (suffixes excluded)."""
    return _DETERMINISTIC + _RANDOM + _SPECTRUM


def generate_matrix_usage() -> str:
    """Human-readable kind list (≅ generate_matrix_usage, generate_matrix_utils.cc:61-143)."""
    return __doc__.split("Kind grammar")[1]


# ---------------------------------------------------------------------------
# threefry2x32 on int64 tensors (words masked to 32 bits: torch's uint32 has no
# add or shifts on the CPU).  A key is a pair of int64 tensors (k1, k2).

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash of the count pair (x0, x1) under key (k1, k2),
    20 rounds; all arguments broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _prng_key(seed: int, device):
    """``jax.random.PRNGKey(seed)``: the 64-bit seed's high and low words."""
    seed = int(seed)
    return (torch.tensor((seed >> 32) & _M32, device=device),
            torch.tensor(seed & _M32, device=device))


def _fold_in(key, data):
    """``jax.random.fold_in``: hash of the count pair (0, data); ``data`` may
    be a tensor of block indices (the keys broadcast against it)."""
    data = torch.as_tensor(data, device=key[0].device) & _M32
    return _threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def _split(key, num: int = 2):
    """``jax.random.split`` (partitionable layout): key i is the hash of the
    count pair (0, i)."""
    return [_fold_in(key, i) for i in range(num)]


def _bits(key, count: int):
    """The two threefry words for counts 0..count-1 under keys of shape
    (..., 1): each (..., count) int64."""
    lo = torch.arange(count, dtype=torch.int64, device=key[0].device)
    return _threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)


def _uniform_bits(b1, b2, dtype):
    """Floats in [1, 2) - 1 from the threefry words, as ``jax.random.uniform``
    builds them: 32-bit dtypes take the mantissa from b1 ^ b2, float64 from the
    64-bit word (b1 << 32) | b2."""
    if dtype == torch.float64:
        mant = (b1 << 20) | (b2 >> 12)
        return (mant | 0x3FF0000000000000).view(torch.float64) - 1.0
    mant = (b1 ^ b2) >> 9
    return (mant | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _fma(a, b, c):
    """a·b + c rounded once, as XLA contracts a multiply feeding an add
    (``addcmul`` is fused on the CPU)."""
    if not isinstance(c, torch.Tensor):
        c = torch.full_like(a, c)
    return torch.addcmul(c, a, b)


def _uniform(key, count: int, dtype, minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, (count,), dtype, minval, maxval)`` for keys of
    shape (..., 1)."""
    b1, b2 = _bits(key, count)
    floats = _uniform_bits(b1, b2, dtype)
    lo = torch.tensor(minval, dtype=dtype, device=floats.device)
    hi = torch.tensor(maxval, dtype=dtype, device=floats.device)
    return torch.maximum(lo, _fma(floats, (hi - lo).expand_as(floats), lo.expand_as(floats)))


# XLA's erf_inv (Giles' single- and double-precision approximations; the
# stablehlo/XLA ErfInv32 and ErfInv64 expansions).  ``torch.special.erfinv`` is
# more accurate in the tails (XLA's float64 misses by up to ~3000 ulp near
# |u| = 1), so the port evaluates XLA's polynomial, with the fused
# multiply-adds XLA's CPU code forms, to draw the JAX package's normals; what
# still differs is a last bit of log, log1p and the rest of the contractions.
_ERFINV32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))
_ERFINV64_LT_6_25 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_ERFINV64_LT_16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV64_GE_16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)


# XLA's log1p (its elemental emitter): Cephes' rational approximation below
# sqrt(2) - 1, log(1 + x) above; numerator and denominator highest degree first
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p(x):
    """XLA's log1p, within 1 ulp of it (``torch.log1p`` differs by up to 129
    ulp from XLA's in float64)."""
    def horner(coefs):
        p = torch.zeros_like(x)
        for c in coefs:
            p = _fma(p, x, c)
        return p

    x2 = x * x
    small = x + ((-0.5 * x2) + (x * x2) * (horner(_LOG1P_NUM) / horner(_LOG1P_DEN)))
    return torch.where(x.abs() < 0.41421356237309504880, small, torch.log(x + 1))


def _erf_inv(x):
    """XLA's ``erf_inv``: a Horner polynomial in w = -log1p(-x²) (shifted, or
    sqrt(w) shifted, by regime), times x; ±1 maps to ±inf."""
    w = -_log1p(-x * x)
    if x.dtype == torch.float64:
        lt6, lt16 = w < 6.25, w < 16

        def coef(i):
            c = torch.full_like(x, _ERFINV64_LT_6_25[i])
            if i < 19:
                c = torch.where(lt6, c, _ERFINV64_LT_16[i])
            if i < 17:
                c = torch.where(lt16, c, _ERFINV64_GE_16[i])
            return c

        w = torch.where(lt6, w - 3.125,
                        torch.sqrt(w) - torch.where(lt16, 3.25, 5.0).to(x.dtype))
        p = coef(0)
        for i in range(1, 17):
            p = _fma(p, w, coef(i))
        for i in range(17, 19):
            p = torch.where(lt16, _fma(p, w, coef(i)), p)
        for i in range(19, 23):
            p = torch.where(lt6, _fma(p, w, coef(i)), p)
    else:
        lt5 = w < 5.0
        coef = lambda i: torch.where(lt5, _ERFINV32[0][i], _ERFINV32[1][i]).to(x.dtype)
        w = torch.where(lt5, w - 2.5, torch.sqrt(w) - 3.0)
        p = coef(0)
        for i in range(1, 9):
            p = _fma(p, w, coef(i))
    return torch.where(x.abs() == 1, x * math.inf, p * x)


def _normal(key, count: int, dtype):
    """``jax.random.normal`` (real): sqrt(2)·erf_inv(u), u uniform on
    (nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.array(-1.0, _np_dtype(dtype)),
                            np.array(0.0, _np_dtype(dtype))))
    u = _uniform(key, count, dtype, lo, 1.0)
    return _erf_inv(u) * torch.tensor(math.sqrt(2), dtype=dtype, device=u.device)


def _bernoulli_half(key, count: int):
    """``jax.random.bernoulli(key, 0.5)``: a float64 uniform below 0.5, i.e.
    the top bit of the high word clear."""
    b1, _ = _bits(key, count)
    return (b1 >> 31) == 0


def _rademacher(key, count: int, dtype):
    """``jax.random.rademacher``: 2·bernoulli(0.5) − 1."""
    return (2 * _bernoulli_half(key, count).to(torch.int64) - 1).to(dtype)


# ---------------------------------------------------------------------------
# dtypes and limits

def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return dtype.to_real() if dtype.is_complex else dtype


def _np_dtype(dtype: torch.dtype):
    return np.dtype(str(dtype).replace("torch.", ""))


def _limits(dtype):
    info = torch.finfo(_real_dtype(dtype))
    ufl = float(info.tiny)
    ofl = 1.0 / ufl
    return ufl, ofl, float(info.eps)


def _parse_kind(kind: str, dtype, cond: Optional[float], condD: Optional[float]):
    """Decode base kind + dist + scaling + modifiers (≅ decode_matrix,
    generate_matrix_utils.cc:166+)."""
    tokens = re.split(r"[-_]", kind)
    if not tokens or not tokens[0]:
        raise SlateError("empty matrix kind")
    base = tokens[0]
    if base == "spd":
        base = "poev"
    if base == "syev":
        base = "heev"
    if base not in matrix_kinds():
        raise SlateError(f"unknown matrix kind base '{tokens[0]}' in '{kind}'")

    ufl, ofl, eps = _limits(dtype)
    dist = "logrand"
    sigma_max = 1.0
    dominant = False
    zero_col = None
    for tok in tokens[1:]:
        if tok in _DISTS:
            dist = tok
        elif tok == "ufl":
            sigma_max = ufl * (1 / eps)    # representable but near underflow
        elif tok == "ofl":
            sigma_max = ofl * eps
        elif tok == "small":
            sigma_max = math.sqrt(ufl)
        elif tok == "large":
            sigma_max = math.sqrt(ofl)
        elif tok == "dominant":
            dominant = True
        elif tok.startswith("zerocol"):
            frac_or_n = tok[len("zerocol"):]
            zero_col = float(frac_or_n) if "." in frac_or_n else int(frac_or_n)
        elif tok == "":
            continue
        else:
            raise SlateError(f"unknown suffix '_{tok}' in matrix kind '{kind}'")

    cond = (1.0 / math.sqrt(eps)) if cond is None else float(cond)
    condD = 1.0 if condD is None else float(condD)
    return base, dist, cond, condD, sigma_max, dominant, zero_col


# ---------------------------------------------------------------------------
# deterministic kinds: entry(i, j) formulas on global 0-based int64 index grids
# (≅ the entry_type lambdas, generate_matrix_ge.cc:100-460).  Each formula keeps
# the JAX package's dtypes step by step (float64 where it mixes an index with a
# Python float), so the entries agree bit for bit.

def _libm(name: str, x):
    """float64 ``cos``/``sin`` as numpy evaluates them on the CPU, which the JAX
    package's CPU results match (torch's vectorized kernels differ by an ulp
    at large arguments); on the card, torch's."""
    if x.device.type == "cpu":
        return torch.from_numpy(getattr(np, name)(x.numpy()))
    return getattr(torch, name)(x)


def _entries(base: str, I, J, m: int, n: int, rdtype):
    f64 = torch.float64
    one = torch.ones((), dtype=rdtype, device=I.device)
    zero = torch.zeros((), dtype=rdtype, device=I.device)
    mx = max(m, n)
    R = lambda x: x.to(rdtype)
    if base == "zeros":
        return torch.zeros(I.shape, dtype=rdtype, device=I.device)
    if base == "ones":
        return torch.ones(I.shape, dtype=rdtype, device=I.device)
    if base == "identity":
        return R(I == J)
    if base == "ij":
        s = 1.0 / 10 ** math.ceil(math.log10(n)) if n > 1 else 0.1
        return R(I) + R(J) * s
    if base == "jordan":
        return R((I == J) | (I + 1 == J))
    if base == "jordanT":
        return R((I == J) | (I - 1 == J))
    if base == "chebspec":
        x = lambda K: R(_libm("cos", math.pi * (K + 1).to(f64) / mx))
        xi, xj = x(I), x(J)
        ci = torch.where(I == mx - 1, 2.0, 1.0).to(rdtype)
        cj = torch.where(J == mx - 1, 2.0, 1.0).to(rdtype)
        sgn = torch.where((I + J) % 2 == 0, 1.0, -1.0).to(rdtype)
        off = sgn * ci / (cj * (xj - xi + torch.where(I == J, one, zero)))
        last = (2.0 * mx * mx + 1) / -6.0
        diag = torch.where(J + 1 == mx, last, -0.5 * xi / (1 - xi * xi))
        return torch.where(I == J, diag, off)
    if base == "circul":
        d = J - I
        return R(d + torch.where(d < 0, mx, 0) + 1)
    if base == "fiedler":
        return R(torch.abs(J - I))
    if base == "gfpp":
        return torch.where(J == n - 1, one,
                           torch.where(I > J, -one,
                                       torch.where(I == J, 0.5 * one, zero)))
    if base == "kms":
        # powers below the smallest normal flush to zero, as the JAX package's
        # CPU results do
        v = torch.pow(0.5, R(torch.abs(J - I)))
        return torch.where(v < torch.finfo(rdtype).tiny, zero, v)
    if base == "orthog":
        outer = math.sqrt(2.0 / (mx + 1))
        return R(outer * _libm("sin", ((I + 1) * (J + 1)).to(f64) * (math.pi / (mx + 1))))
    if base == "riemann":
        # entry = i+1 when (i+2) divides (j+2), else -1 (gallery('riemann'),
        # generate_matrix_utils.cc:88)
        return torch.where((J + 2) % (I + 2) == 0, R(I + 1), -one)
    if base == "ris":
        return 0.5 / R((mx - J - I).to(f64) - 0.5)
    if base == "zielkeNS":
        return torch.where(J < I, one,
                           torch.where((J + 1 == mx) & (I == 0), -one, zero))
    if base == "minij":
        return R(torch.minimum(I, J) + 1)
    if base == "hilb":
        return 1.0 / R(I + J + 1)
    if base == "frank":
        return torch.where(I - J > 1, zero,
                           torch.where(I - J == 1, R(mx - J - 1), R(mx - J)))
    if base == "lehmer":
        return R(torch.minimum(I, J) + 1) / R(torch.maximum(I, J) + 1)
    if base == "lotkin":
        return torch.where(I == 0, one, 1.0 / R(I + J + 1))
    if base == "redheff":
        return R(((J + 1) % (I + 1) == 0) | (J == 0))
    if base == "triw":
        return torch.where(I == J, one, torch.where(I > J, zero, -one))
    if base == "pei":
        return torch.where(I == J, 2 * one, one)
    if base == "tridiag":
        return torch.where(I == J, 2 * one,
                           torch.where(torch.abs(I - J) == 1, -one, zero))
    if base == "toeppen":
        return torch.where(torch.abs(J - I) == 1, R(J - I) * 10,
                           torch.where(torch.abs(I - J) == 2, one, zero))
    if base == "parter":
        return 1.0 / R((I - J).to(f64) + 0.5)
    if base == "moler":
        return torch.where(I == J, R(I + 1), R(torch.minimum(I, J) - 1))
    if base == "cauchy":
        return 1.0 / R(I + J + 2)
    if base == "chow":
        return torch.where(I - J < -1, zero, one)
    if base == "clement":
        return torch.where(I - J == 1, R(mx - J - 1),
                           torch.where(I - J == -1, R(J), zero))
    if base == "gcdmat":
        return R(torch.gcd(I + 1, J + 1))
    raise SlateError(f"unhandled deterministic kind '{base}'")


def _index_grids(i0: int, mb: int, j0: int, nb: int, device):
    I = torch.arange(i0, i0 + mb, dtype=torch.int64, device=device)
    J = torch.arange(j0, j0 + nb, dtype=torch.int64, device=device)
    return torch.meshgrid(I, J, indexing="ij")


# ---------------------------------------------------------------------------
# random kinds: counter-based per canonical block

def _block_values(base: str, key, dtype):
    """Canonical (NB x NB) blocks for keys of shape (..., 1): (..., NB*NB)
    values (≅ random::generate taking (i_global, j_global),
    generate_type_rand.hh:65-68)."""
    count = _GEN_NB * _GEN_NB
    if dtype.is_complex:
        kr, ki = _split(key)
        rdt = _real_dtype(dtype)
        re = _block_values(base, _fold_in(_fold_in(kr, 0), 0), rdt)
        im = _block_values(base, _fold_in(_fold_in(ki, 0), 0), rdt)
        return torch.complex(re, im)
    if base == "rand":
        return _uniform(key, count, dtype)
    if base == "rands":
        return _uniform(key, count, dtype, -1.0, 1.0)
    if base == "randn":
        return _normal(key, count, dtype)
    if base == "randb":
        return _bernoulli_half(key, count).to(dtype)
    if base == "randr":
        return _rademacher(key, count, dtype)
    raise SlateError(f"unhandled random kind '{base}'")


def _rand_blocks(base: str, key, bis: range, bjs: range, dtype, device):
    """The canonical blocks bis x bjs assembled into one tensor, drawn a few
    block rows at a time so each int64 temporary stays under _CHUNK_WORDS
    words."""
    out = torch.empty(len(bis) * _GEN_NB, len(bjs) * _GEN_NB, dtype=dtype,
                      device=device)
    bj = torch.tensor(list(bjs), dtype=torch.int64, device=device)
    per_row = len(bjs) * _GEN_NB * _GEN_NB
    rows = max(1, _CHUNK_WORDS // per_row)
    for r0 in range(0, len(bis), rows):
        bi = torch.tensor(list(bis[r0:r0 + rows]), dtype=torch.int64, device=device)
        ki = _fold_in(key, bi)
        k = _fold_in((ki[0][:, None], ki[1][:, None]), bj[None, :])
        vals = _block_values(base, (k[0][..., None], k[1][..., None]), dtype)
        blocks = vals.reshape(len(bi), len(bjs), _GEN_NB, _GEN_NB)
        out[r0 * _GEN_NB:(r0 + len(bi)) * _GEN_NB] = (
            blocks.permute(0, 2, 1, 3).reshape(len(bi) * _GEN_NB, -1))
    return out


def _rand_full(base: str, key, m: int, n: int, dtype, device):
    """The full matrix from whole canonical blocks (even when one block covers
    the matrix), so the counters — and hence the values — agree with
    generate_tile."""
    bm = -(-m // _GEN_NB)
    bn = -(-n // _GEN_NB)
    return _rand_blocks(base, key, range(bm), range(bn), dtype, device)[:m, :n]


# ---------------------------------------------------------------------------
# sigma distributions (≅ generate_sigma.hh)

def generate_sigma(dist: str, n: int, cond: float, *, rand_sign: bool = False,
                   sigma_max: float = 1.0, seed: int = 0, sigma=None,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """Singular/eigen value vector for the requested distribution (≅
    matgen/generate_sigma.hh; suffix table generate_matrix_utils.cc:120-137)."""
    dev = resolve_device(device)
    rdtype = _real_dtype(torch_dtype(dtype))
    key = _prng_key(seed, dev)
    k1 = (key[0].reshape(1), key[1].reshape(1))
    i = torch.arange(n, dtype=rdtype, device=dev)
    denom = max(n - 1, 1)
    # 1/cond as a float64 tensor: torch.where of two Python floats is float32
    small = torch.full((n,), 1.0 / cond, dtype=torch.float64, device=dev)
    if dist == "specified":
        if sigma is None:
            raise SlateError("dist 'specified' requires sigma=")
        s = torch.as_tensor(sigma, dtype=rdtype, device=dev)
    elif dist == "logrand":
        lo = math.log(1.0 / cond)
        s = torch.exp(_uniform(k1, n, rdtype, lo, 0.0))
    elif dist in ("arith", "rarith"):
        s = 1 - i / denom * (1 - 1 / cond)
    elif dist in ("geo", "rgeo"):
        s = torch.pow(torch.tensor(cond, dtype=rdtype, device=dev), -i / denom)
    elif dist in ("cluster0", "rcluster0"):
        s = torch.where(i == 0, 1.0, small).to(rdtype)
    elif dist in ("cluster1", "rcluster1"):
        s = torch.where(i == n - 1, small, 1.0).to(rdtype)
    elif dist == "rand":
        s = _uniform(k1, n, rdtype)
    elif dist == "rands":
        s = _uniform(k1, n, rdtype, -1.0, 1.0)
    elif dist == "randn":
        s = _normal(k1, n, rdtype)
    else:
        raise SlateError(f"unknown sigma distribution '{dist}'")
    if dist in ("rarith", "rgeo", "rcluster0", "rcluster1"):
        s = torch.flip(s, (0,))
    if rand_sign and dist not in ("rands", "randn"):
        # heev: eigenvalues of mixed sign (poev keeps them positive)
        k17 = _fold_in(key, 17)
        s = s * _rademacher((k17[0].reshape(1), k17[1].reshape(1)), n, rdtype)
    return s * sigma_max


def _haar_q(key, rows: int, cols: int, dtype, device):
    """Random orthonormal (rows x cols) factor: QR of a Gaussian block with the
    sign of R's diagonal folded into Q (the reference forms Q the same way —
    geqrf of a rand matrix, generate_type_heev.hh:60-75)."""
    g = _rand_full("randn", key, rows, cols, dtype, device)
    q, r = torch.linalg.qr(g)
    d = torch.sign(torch.diagonal(r).real)
    d = torch.where(d == 0, 1.0, d).to(dtype)
    return q * d[None, :]


def _cond_diag(key, n: int, condD: float, rdtype):
    """Diagonal scaling with condition condD: log-uniform on [log(1/condD), 0]
    (generate_type_svd.hh:159-170)."""
    lo = math.log(1.0 / condD)
    return torch.exp(_uniform((key[0].reshape(1), key[1].reshape(1)), n, rdtype,
                              lo, 0.0))


def _zero_col_index(zero_col, n: int) -> int:
    return int(round(zero_col * (n - 1))) if isinstance(zero_col, float) else zero_col


# ---------------------------------------------------------------------------
# public API

def generate_matrix(kind: str, m: int, n: Optional[int] = None, *,
                    dtype=torch.float32, seed: int = 0, cond: Optional[float] = None,
                    condD: Optional[float] = None, sigma=None, device=None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Generate an m x n test matrix of the named kind on ``device`` (``cuda``
    unless named).

    Returns ``(A, Sigma)`` where Sigma is the generated singular/eigenvalue vector
    for spectrum-controlled kinds (diag/svd/poev/heev) and None otherwise.
    ≅ ``slate::generate_matrix`` (matgen/generate_matrix.hh:30-71).
    """
    n = m if n is None else n
    dev = resolve_device(device)
    dtype = torch_dtype(dtype)
    base, dist, cond, condD, sigma_max, dominant, zero_col = _parse_kind(
        kind, dtype, cond, condD)
    rdtype = _real_dtype(dtype)
    key = _prng_key(seed, dev)
    S = None

    if base in _DETERMINISTIC:
        I, J = _index_grids(0, m, 0, n, dev)
        A = _entries(base, I, J, m, n, rdtype).to(dtype)
        if sigma_max != 1:
            A = A * sigma_max
    elif base in _RANDOM:
        A = _rand_full(base, key, m, n, dtype, dev)
        if sigma_max != 1:
            A = A * sigma_max
    elif base == "diag":
        mn = min(m, n)
        S = generate_sigma(dist, mn, cond, sigma_max=sigma_max, seed=seed,
                           sigma=sigma, dtype=dtype, device=dev)
        A = torch.zeros((m, n), dtype=dtype, device=dev)
        A.diagonal()[:] = S.to(dtype)
    elif base == "svd":
        mn = min(m, n)
        S = generate_sigma(dist, mn, cond, sigma_max=sigma_max, seed=seed,
                           sigma=sigma, dtype=dtype, device=dev)
        kU, kV, kD = _split(_fold_in(key, 1), 3)
        U = _haar_q(kU, m, mn, dtype, dev)
        V = _haar_q(kV, n, mn, dtype, dev)
        A = (U * S.to(dtype)[None, :]) @ V.conj().T
        if condD != 1:
            A = A * _cond_diag(kD, n, condD, rdtype).to(dtype)[None, :]
    elif base in ("poev", "heev"):
        if m != n:
            raise SlateError(f"kind '{kind}' requires a square matrix")
        S = generate_sigma(dist, n, cond, rand_sign=(base == "heev"),
                           sigma_max=sigma_max, seed=seed, sigma=sigma, dtype=dtype,
                           device=dev)
        kU, kD = _split(_fold_in(key, 1))
        U = _haar_q(kU, n, n, dtype, dev)
        A = (U * S.to(dtype)[None, :]) @ U.conj().T
        A = (A + A.conj().T) / 2
        if condD != 1:
            d = _cond_diag(kD, n, condD, rdtype).to(dtype)
            A = A * d[None, :] * d[:, None]      # two-sided D A D
            A = (A + A.conj().T) / 2
    else:  # pragma: no cover
        raise SlateError(f"unhandled kind '{kind}'")

    if dominant:
        # the reference bumps the diagonal by n BEFORE the sigma_max scaling
        # (generate_type_rand.hh:70-83), so the bump scales with the matrix
        A.diagonal()[:] += torch.tensor(n * sigma_max, dtype=dtype, device=dev)
    if zero_col is not None:
        col = _zero_col_index(zero_col, n)
        if not 0 <= col < n:
            raise SlateError(f"zerocol index {col} out of range [0, {n})")
        A[:, col] = 0
        if base in ("poev", "heev") or (m == n and base in ("hilb", "minij", "pei")):
            A[col, :] = 0
    return A, S


def generate_tile(kind: str, i0: int, j0: int, mb: int, nb: int, m: int, n: int, *,
                  dtype=torch.float32, seed: int = 0, device=None) -> torch.Tensor:
    """Generate just the (mb x nb) sub-block at global offset (i0, j0) without
    materializing the rest — the counter-based-RNG property that lets every
    device build its own shard independently (≅ random::generate with global
    offsets, generate_type_rand.hh:65-68).

    Supported for deterministic and random kinds (spectrum-controlled kinds need
    the global factors, use generate_matrix).
    """
    dev = resolve_device(device)
    dtype = torch_dtype(dtype)
    base, dist, cond, condD, sigma_max, dominant, zero_col = _parse_kind(
        kind, dtype, None, None)
    rdtype = _real_dtype(dtype)
    if base in _DETERMINISTIC:
        I, J = _index_grids(i0, mb, j0, nb, dev)
        tile = _entries(base, I, J, m, n, rdtype).to(dtype)
    elif base in _RANDOM:
        # cover with canonical aligned blocks, then slice
        b0, b1 = i0 // _GEN_NB, (i0 + mb - 1) // _GEN_NB
        c0, c1 = j0 // _GEN_NB, (j0 + nb - 1) // _GEN_NB
        cover = _rand_blocks(base, _prng_key(seed, dev), range(b0, b1 + 1),
                             range(c0, c1 + 1), dtype, dev)
        tile = cover[i0 - b0 * _GEN_NB: i0 - b0 * _GEN_NB + mb,
                     j0 - c0 * _GEN_NB: j0 - c0 * _GEN_NB + nb]
    else:
        raise SlateError(
            f"generate_tile supports deterministic/random kinds, not '{kind}'")
    if sigma_max != 1:
        tile = tile * sigma_max
    if dominant or zero_col is not None:
        I, J = _index_grids(i0, mb, j0, nb, dev)
        if dominant:
            # bump scaled by sigma_max to match the reference's pre-scale order
            tile = torch.where((I == J) & (I < min(m, n)), tile + n * sigma_max, tile)
        if zero_col is not None:
            col = _zero_col_index(zero_col, n)
            tile = torch.where(J == col, torch.zeros((), dtype=dtype, device=dev), tile)
            if m == n and base in ("hilb", "minij", "pei"):  # symmetric kinds zero the row too
                tile = torch.where(I == col, torch.zeros((), dtype=dtype, device=dev),
                                   tile)
    return tile
