"""Secret and cloud (evaluation) keys: generation, preparation, serialization.

Reference: key/key.go (secret keys), cloudkey/cloudkey.go (testvec, KSK, BSK).
The reference generates KSK/BSK entries with a goroutine per index
(cloudkey/cloudkey.go:99-144); here the whole keygen is one batched jitted
program.  Unlike the reference — which keeps keys only in process memory —
keys are serializable to ``.npz`` (SURVEY.md flags this as a genuine
capability gap: keygen is 5-10s upstream with nothing persisted).

CloudKey carries the bootstrapping key in the form the external product
reads (the analogue of the reference's FFT form, trgsw/trgsw.go:71-82):
balanced int8 limbs of each TRGSW row's signed D band (ops/polymul.py).

Profile compatibility: SecretKeys and level-0 ciphertexts depend only on
the crypto parameters (lwe_n, N, alphas) and are interchangeable between a
base profile and its ``*_fast`` variant; CloudKeys are NOT — the fast
profiles bake a bgbit=8/l=2 gadget, a centered decomposition offset and an
on-grid (q=2^24) BSK into keygen (params.P128_FAST).
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
import jax
import jax.numpy as jnp
import numpy as np

from . import cipher
from .params import TFHEParams, get_params
from .ops.polymul import prepare_band_limbs
from .utils.rng import binary_key, block_binary_key
from .utils.torus import TORUS, f64_to_torus

Array = jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SecretKey:
    """Binary secret keys for both levels (key/key.go:10-13).

    ``block_binary``: the lv0 key was sampled block-binary (Hamming weight
    <= 1 per block of ``params.block_size`` bits), enabling block blind
    rotation.  The lv1 ring key is always uniform binary.
    """
    lv0: Array  # (lwe_n,) uint32 in {0,1}
    lv1: Array  # (n,)     uint32 in {0,1}
    block_binary: bool = dataclasses.field(
        default=False, metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CloudKey:
    """Public evaluation key (cloudkey/cloudkey.go:16-21).

    ``params`` is pytree metadata (static under jit), so jitted functions
    taking a CloudKey re-specialize per profile automatically.
    """
    testvec: Array      # (2, N) uint32 — constant-1/8 test vector
    ksk: Array          # (N, iks_t, base, lwe_n+1) uint32; [.., 0, :] == 0
    bsk: Array          # (lwe_n, 2L, 2, N) uint32 — raw TRGSW form
    bsk_limbs: Array    # (4-kernel_limb_drop, lwe_n, 2L, 2, 2N) int8 limbs
    #                     of the signed D bands: what the external product
    #                     reads (ops/polymul.prepare_band_limbs)
    params: TFHEParams = dataclasses.field(metadata=dict(static=True))
    # The underlying lv0 key is block-binary, so the engine may use block
    # blind rotation (params.block_size bits per sequential step).
    block_binary: bool = dataclasses.field(
        default=False, metadata=dict(static=True))

    @property
    def decomposition_offset(self) -> int:
        return self.params.decomposition_offset


def gen_secret_key(rng: Array, p: TFHEParams,
                   block_binary: bool = False) -> SecretKey:
    """key/key.go:16-45.

    The default samples both levels **uniform binary** — the distribution
    the reference actually uses (key/key.go:25-39); its BlockSize fields are
    dead config.  Pass ``block_binary=True`` to opt into a block-binary lv0
    key (Hamming weight <= 1 per block of ``p.block_size`` bits), which
    enables block blind rotation (block_size x fewer sequential steps).

    SECURITY CAVEAT for ``block_binary=True``: a block-binary key has
    log2(block_size+1)/block_size entropy bits per key bit (< 1), so a
    profile's nominal security level does NOT automatically carry over.
    Measured estimate (primal uSVP + guess-and-reduce,
    tools/security_estimate.py, table in SECURITY.md): at the 128-bit
    profile the cost drops from 107.2 classical core-SVP bits (uniform)
    to 105.1 at block_size=3 (the shipped BlockSize) and 97.6 at
    block_size=8.  The reference never samples such keys — this is an
    explicit, documented, quantified deviation.
    """
    k0, k1 = jax.random.split(rng)
    if block_binary and p.block_size <= 1:
        raise ValueError(
            f"profile {p.name!r} has block_size {p.block_size}; "
            "block-binary keys need block_size > 1")
    lv0 = (block_binary_key(k0, p.lwe_n, p.block_size) if block_binary
           else binary_key(k0, p.lwe_n))
    return SecretKey(lv0=lv0, lv1=binary_key(k1, p.n),
                     block_binary=block_binary)


def gen_testvec(p: TFHEParams) -> Array:
    """Constant 1/8 test vector: A = 0, B[i] = T(1/8) for all i
    (cloudkey/cloudkey.go:74-85).  For extended profiles
    (poly_extend_factor k > 1) the big constant polynomial interleaves into
    k identical constant blocks, shape (k, 2, N)."""
    k = p.poly_extend_factor
    tv = np.zeros((k, 2, p.n), np.uint32)
    tv[:, 1, :] = f64_to_torus(0.125)
    return jnp.asarray(tv[0] if k == 1 else tv)


@functools.partial(jax.jit, static_argnums=1)
def _gen_ksk(rng: Array, p: TFHEParams, sk: SecretKey) -> Array:
    """KSK[i,j,k] encrypts k * s1[i] / 2^((j+1)*basebit); k==0 rows are zero
    ciphertexts (cloudkey/cloudkey.go:88-120)."""
    ks = jnp.arange(p.base, dtype=jnp.uint32)
    shifts = jnp.asarray([32 - (j + 1) * p.basebit for j in range(p.iks_t)],
                         dtype=jnp.uint32)
    # mu[i, j, k] = (k * s1[i]) << (32 - (j+1)*basebit), exact dyadic torus.
    mu = (ks[None, None, :] * sk.lv1[:, None, None]) << shifts[None, :, None]
    ct = cipher.lwe_encrypt_torus(rng, mu, p.ksk_alpha, sk.lv0)
    mask = (ks > 0)[None, None, :, None]
    return jnp.where(mask, ct, jnp.uint32(0))


@functools.partial(jax.jit, static_argnums=1)
def _gen_bsk(rng: Array, p: TFHEParams, sk: SecretKey) -> Array:
    """BSK[i] = TRGSW encryption of LWE key bit s0[i]
    (cloudkey/cloudkey.go:123-145)."""
    return cipher.trgsw_encrypt_torus(rng, sk.lv0, p.bsk_alpha, sk.lv1, p)


@functools.partial(jax.jit, static_argnums=1)
def prepare_bsk_limbs(bsk: Array, p: TFHEParams) -> Array:
    """Raw BSK -> int8 limbs of its signed D bands (the 'FFT form'
    analogue), dropping the ``kernel_limb_drop`` low limbs that the on-grid
    keygen makes zero."""
    return prepare_band_limbs(bsk, p.kernel_limb_drop)


def _warn_marginal_profile(p: TFHEParams) -> None:
    """The floor-gadget extended profiles Uint7/Uint8 are measurably
    unreliable (the floor offset's bias random walk exceeds the message-space
    tolerance; the reference never ran them, params/UINT_STATUS.md).
    Warn at keygen so a user selecting get_params('uint7'/'uint8') gets a
    runtime signal pointing at the accurate *_centered variants."""
    if (p.poly_extend_factor > 1 and not p.centered_decomposition
            and p.message_modulus >= 128):
        warnings.warn(
            f"profile {p.name!r} uses the reference's floor gadget offset, "
            f"whose bias random-walk exceeds the message-space tolerance at "
            f"messageModulus={p.message_modulus}, so a share of its PBS "
            f"outputs decode wrong.  Use "
            f"get_params('{p.name}_centered') for the 100%-accurate "
            f"centered-gadget variant (same crypto parameters).",
            stacklevel=3)


def gen_cloud_key(rng: Array, sk: SecretKey, p: TFHEParams) -> CloudKey:
    """cloudkey/cloudkey.go:24-31 (DecompositionOffset lives in params)."""
    _warn_marginal_profile(p)
    k_ksk, k_bsk = jax.random.split(rng)
    bsk = _gen_bsk(k_bsk, p, sk)
    return CloudKey(
        testvec=gen_testvec(p),
        ksk=_gen_ksk(k_ksk, p, sk),
        bsk=bsk,
        bsk_limbs=prepare_bsk_limbs(bsk, p),
        params=p,
        block_binary=sk.block_binary,
    )


def gen_cloud_key_no_ksk(p: TFHEParams) -> CloudKey:
    """All-zero dummy keys for tests (cloudkey/cloudkey.go:34-57)."""
    bsk = jnp.zeros((p.lwe_n, 2 * p.l, 2, p.n), TORUS)
    return CloudKey(
        testvec=gen_testvec(p),
        ksk=jnp.zeros((p.n, p.iks_t, p.base, p.lwe_n + 1), TORUS),
        bsk=bsk,
        bsk_limbs=prepare_bsk_limbs(bsk, p),
        params=p,
    )


# ---------------------------------------------------------------------------
# Serialization (new capability vs. the reference).
# ---------------------------------------------------------------------------

def save_secret_key(path: str, sk: SecretKey) -> None:
    np.savez_compressed(path, lv0=np.asarray(sk.lv0), lv1=np.asarray(sk.lv1),
                        block_binary=np.asarray(sk.block_binary))


def load_secret_key(path: str) -> SecretKey:
    z = np.load(path)
    return SecretKey(lv0=jnp.asarray(z["lv0"]), lv1=jnp.asarray(z["lv1"]),
                     block_binary=bool(z.get("block_binary", False)))


def save_cloud_key(path: str, ck: CloudKey) -> None:
    np.savez_compressed(
        path,
        profile=np.asarray(ck.params.name),
        testvec=np.asarray(ck.testvec),
        ksk=np.asarray(ck.ksk),
        bsk=np.asarray(ck.bsk),
        block_binary=np.asarray(ck.block_binary),
    )


def load_cloud_key(path: str) -> CloudKey:
    z = np.load(path)
    p = get_params(str(z["profile"]))
    bsk = jnp.asarray(z["bsk"])
    return CloudKey(
        testvec=jnp.asarray(z["testvec"]),
        ksk=jnp.asarray(z["ksk"]),
        bsk=bsk,
        bsk_limbs=prepare_bsk_limbs(bsk, p),
        params=p,
        block_binary=bool(z.get("block_binary", False)),
    )
