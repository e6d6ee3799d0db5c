"""Port vs helib_tpu: host-seeded key generation, encryption and decryption
at m=31, and state carried across with helib_tpu_torch.convert."""

import numpy as np
import pytest
import torch

from helib_tpu.context import Context as JContext
from helib_tpu.ctxt import Ctxt as JCtxt
from helib_tpu.keys import SecKey as JSecKey, PubKey as JPubKey
from helib_tpu.keys import SKHandle as JSKHandle

from helib_tpu_torch import convert
from helib_tpu_torch.context import Context as TContext
from helib_tpu_torch.keys import SecKey as TSecKey, PubKey as TPubKey
from helib_tpu_torch.keys import SKHandle
from helib_tpu_torch.exceptions import InvalidArgument
from helib_tpu_torch.ops.modops import to_host

torch.set_num_threads(1)

PARAMS = dict(m=31, p=2, r=1, bits=300, c=3)


@pytest.fixture(scope="module")
def both():
    jc, tc = JContext(**PARAMS), TContext(**PARAMS, device="cpu")
    jsk, tsk = JSecKey(jc, seed=7), TSecKey(tc, seed=7)
    jsk.gen_ks_matrix(JSKHandle(2, 1, 0))
    tsk.gen_ks_matrix(SKHandle(2, 1, 0))
    return jc, tc, jsk, tsk, JPubKey(jsk), TPubKey(tsk)


def _eq(t, a):
    np.testing.assert_array_equal(to_host(t), np.asarray(a))


def _seckey_arrays(jsk):
    return dict(
        skeys=[{"coeffs": s["coeffs"], "bound": s["bound"],
                "full": np.asarray(s["full"])} for s in jsk.skeys],
        matrices={k: convert.ksmatrix_arrays(W)
                  for k, W in jsk.matrices.items()},
        rng_state=jsk.rng.bit_generator.state)


def test_seckey_pubkey_and_relin_matrix_bit_equal(both):
    jc, tc, jsk, tsk, jpk, tpk = both
    np.testing.assert_array_equal(tsk.s_coeffs, jsk.s_coeffs)
    assert tsk.sk_bound == jsk.sk_bound
    _eq(tsk.s_full, jsk.s_full)
    jW, tW = jsk.matrices[(2, 1)], tsk.matrices[(2, 1)]
    assert (tW.prg_seed, tW.ptxt_space, tW.noise) == (
        jW.prg_seed, jW.ptxt_space, jW.noise)
    for t, a in zip(tW.b + tW.a, jW.b + jW.a):
        _eq(t, a)
    assert tpk.enc_noise == jpk.enc_noise
    for (th, t), (jh, a) in zip(tpk.enc_key, jpk.enc_key):
        assert (th.powS, th.powX) == (jh.powS, jh.powX)
        _eq(t, a)


def test_convert_carries_keys_and_keygen_stream(both):
    jc, tc, _, _, _, _ = both
    ctx = convert.context_from_params(convert.context_params(jc), "cpu")
    jsk = JSecKey(jc, seed=11)
    sk = convert.seckey_from_arrays(ctx, **_seckey_arrays(jsk))
    _eq(sk.s_full, jsk.s_full)
    # the carried RNG state continues the same keygen stream
    W = sk.gen_ks_matrix(SKHandle(1, 3, 0))
    jW = jsk.gen_ks_matrix(JSKHandle(1, 3, 0))
    assert W.prg_seed == jW.prg_seed
    for t, a in zip(W.b + W.a, jW.b + jW.a):
        _eq(t, a)


def test_encrypt_and_carried_decrypt_both_ways(both):
    jc, tc, jsk, _, jpk, _ = both
    ctx = convert.context_from_params(convert.context_params(jc), "cpu")
    sk = convert.seckey_from_arrays(ctx, **_seckey_arrays(jsk))
    pk = convert.pubkey_from_arrays(
        ctx, [((h.powS, h.powX, h.keyID), np.asarray(d))
              for h, d in jpk.enc_key], jpk.enc_noise, jpk.sk_bound,
        sk.matrices)
    pt = np.random.default_rng(2).integers(0, 2, jc.phi_m)
    jct = jpk.encrypt_bgv(pt, np.random.default_rng(5))
    tct = pk.encrypt_bgv(pt, np.random.default_rng(5))   # same host RNG
    assert abs(tct.noise - jct.noise) <= 1e-9
    for (_, t), (_, a) in zip(tct.parts, jct.parts):
        _eq(t, a)
    # a JAX ciphertext carried over decrypts under the carried key ...
    carried = convert.ctxt_from_arrays(
        ctx, pk, [((h.powS, h.powX, h.keyID), np.asarray(d))
                  for h, d in jct.parts],
        jct.k, jct.special, jct.ptxt_space, jct.noise, jct.intFactor)
    np.testing.assert_array_equal(sk.decrypt_bgv(carried), pt)
    # ... and a port ciphertext carried back decrypts under the JAX key
    import jax.numpy as jnp
    back = JCtxt(jc, jpk, [(JSKHandle(*h), jnp.asarray(d))
                           for h, d in convert.ctxt_to_arrays(tct)],
                 tct.k, tct.special, tct.ptxt_space, tct.noise)
    np.testing.assert_array_equal(jsk.decrypt_bgv(back), pt)


def test_context_defaults_to_cuda_and_checks_m():
    with pytest.raises(InvalidArgument, match="power-of-2"):
        TContext(m=64, p=3, device="cpu")
    if torch.cuda.is_available():
        assert TContext(**PARAMS).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TContext(**PARAMS)
