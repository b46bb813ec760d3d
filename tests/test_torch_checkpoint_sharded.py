"""Checkpoint, resume and conversion of the sharded streams' carries on the
CPU (tests/test_checkpoint_sharded.py's cases, at its sizes).

A ``TimeShardedStream`` (both halo forms) and a ``ChannelShardedBank`` on
a ``LocalMesh(device='cpu')`` saved mid-stream with
``graph.checkpoint.save_state`` and resumed by a fresh object through
``load_state`` continue bit for bit as the uninterrupted run.  Their
carries cross between the packages with ``convert.state_from_numpy`` and
``state_to_numpy``: JAX's ``Complex`` tails become complex64 tensors and
come back as (re, im) pairs, phases stay uint32 on JAX's side.  A JAX
carry taken across continues in the port, and the port's in JAX, each to
the other package's audio within -80 dB of error energy (the ROADMAP's
bar for audio).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from tests.test_channels_sharded import build as j_build_bank
from tests.test_checkpoint_sharded import _wbfm_chain as j_wbfm_chain
from tests.test_torch_channels_sharded import port_bank_blocks
from tests.test_torch_parallel import port_chain
from tpusdr.graph import blocks as JB
from tpusdr.graph.chain import Chain as JChain
from tpusdr.ops import cplx as jcplx
from tpusdr.parallel.channels import ChannelShardedBank as JBank
from tpusdr.parallel.halo import TimeShardedStream as JTSS
from tpusdr.parallel.mesh import make_mesh as j_make_mesh
from tpusdr_torch import convert
from tpusdr_torch.graph import blocks as TB
from tpusdr_torch.graph.chain import Chain
from tpusdr_torch.graph.checkpoint import load_state, save_state
from tpusdr_torch.ops import osc
from tpusdr_torch.parallel import ChannelShardedBank, TimeShardedStream, make_mesh

torch.set_num_threads(1)

AUDIO_DB = -80.0


@pytest.fixture
def rng():
    return np.random.default_rng(55)


def ticks_of(rng, total, n_ticks):
    z = (rng.standard_normal(total) + 1j * rng.standard_normal(total)).astype(np.complex64)
    n = total // n_ticks
    return [z[i * n : (i + 1) * n] for i in range(n_ticks)]


def err_db(ref, got):
    return 10 * np.log10(np.sum(np.abs(ref - got) ** 2) / np.sum(np.abs(ref) ** 2))


def to_jax(tcarry, jlike):
    """The port's carry in the structure of the JAX carry ``jlike``."""
    leaves = jax.tree.leaves(convert.state_to_numpy(tcarry))
    return jax.tree.unflatten(jax.tree.structure(jlike), [jnp.asarray(a) for a in leaves])


def from_jax(jcarry):
    return convert.state_from_numpy(jax.tree.map(np.asarray, jcarry))


def resume_equals_continuous(make, blocks, tmp_path):
    """Four ticks straight, against two ticks, a checkpoint, and two more
    from a fresh object that loads it: bit for bit."""
    obj = make()
    carry, ref = obj.init_carry(), []
    for b in blocks:
        carry, y = obj.step(carry, torch.from_numpy(b))
        ref.append(y.numpy())
    first = make()
    carry = first.init_carry()
    for b in blocks[:2]:
        carry, _ = first.step(carry, torch.from_numpy(b))
    path = str(tmp_path / "carry.npz")
    save_state(path, carry)
    second = make()
    carry2 = load_state(path, second.init_carry())
    for b, r in zip(blocks[2:], ref[2:]):
        carry2, y = second.step(carry2, torch.from_numpy(b))
        np.testing.assert_array_equal(y.numpy(), r)


@pytest.mark.parametrize("stagewise", [True, False])
def test_time_sharded_resume_equals_continuous(rng, tmp_path, stagewise):
    chain = port_chain(j_wbfm_chain())
    resume_equals_continuous(lambda: TimeShardedStream(chain, make_mesh(8, device="cpu"), stagewise=stagewise),
                             ticks_of(rng, 8 * 2048 * 4, 4), tmp_path)


def test_structure_mismatch_rejected(tmp_path):
    mesh = make_mesh(4, device="cpu")
    tss = TimeShardedStream(port_chain(j_wbfm_chain()), mesh)
    path = str(tmp_path / "tss.npz")
    save_state(path, tss.init_carry())
    other = TimeShardedStream(Chain([("fir", TB.Fir(sps.firwin(9, 0.4).astype(np.float32), 1))]), mesh)
    with pytest.raises(ValueError, match="do not match|shape"):
        load_state(path, other.init_carry())


def test_channel_sharded_resume_equals_continuous(rng, tmp_path):
    def make():
        jchan, jdemod, _ = j_build_bank()
        return ChannelShardedBank(*port_bank_blocks(jchan, jdemod), make_mesh(4, device="cpu"))

    resume_equals_continuous(make, ticks_of(rng, 8 * 128 * 8, 4), tmp_path)


@pytest.mark.parametrize("stagewise", [True, False])
def test_time_sharded_carry_crosses_both_ways(rng, stagewise):
    """JAX's carry after 2 ticks continues in the port, and the port's in
    JAX; the carries hold the same keys, shapes and kinds (Complex tails
    as complex64, uint32 phases as the port's phase tensors)."""
    jchain = j_wbfm_chain()
    jtss = JTSS(jchain, j_make_mesh(8), stagewise=stagewise)
    tss = TimeShardedStream(port_chain(jchain), make_mesh(8, device="cpu"), stagewise=stagewise)
    blocks = ticks_of(rng, 8 * 2048 * 4, 4)
    jcarry, tcarry = jtss.init_carry(), tss.init_carry()
    for b in blocks[:2]:
        jcarry, _ = jtss.step(jcarry, jcplx.from_numpy(b))
        tcarry, _ = tss.step(tcarry, torch.from_numpy(b))
    crossed = from_jax(jcarry)
    assert set(crossed) == set(tcarry) == {"state", "tail"}
    assert osc.is_phase(crossed["state"]["shift"]) and int(crossed["state"]["shift"]) == int(tcarry["state"]["shift"])
    tails = (crossed["tail"], tcarry["tail"]) if stagewise else ({"": crossed["tail"]}, {"": tcarry["tail"]})
    assert set(tails[0]) == set(tails[1])
    for k, t in tails[0].items():  # complex64 before the discriminator, float32 after
        assert (t.dtype, t.shape) == (tails[1][k].dtype, tails[1][k].shape)
    assert any(t.dtype == torch.complex64 for t in tails[0].values())
    back = to_jax(tcarry, jcarry)
    assert back["state"]["shift"].dtype == jnp.uint32
    for b in blocks[2:]:
        jcarry, jy = jtss.step(jcarry, jcplx.from_numpy(b))
        crossed, ty = tss.step(crossed, torch.from_numpy(b))
        back, by = jtss.step(back, jcplx.from_numpy(b))
        tcarry, y = tss.step(tcarry, torch.from_numpy(b))
        assert err_db(np.asarray(jy), ty.numpy()) <= AUDIO_DB
        assert err_db(y.numpy(), np.asarray(by)) <= AUDIO_DB


def test_channel_sharded_carry_crosses_both_ways(rng):
    jchan, jdemod, _ = j_build_bank()
    jbank = JBank(jchan, jdemod, j_make_mesh(4))
    bank = ChannelShardedBank(*port_bank_blocks(jchan, jdemod), make_mesh(4, device="cpu"))
    blocks = ticks_of(rng, 8 * 128 * 8, 4)
    jcarry, tcarry = jbank.init_carry(), bank.init_carry()
    for b in blocks[:2]:
        jcarry, _ = jbank.step(jcarry, jcplx.from_numpy(b))
        tcarry, _ = bank.step(tcarry, torch.from_numpy(b))
    crossed = from_jax(jcarry)
    assert crossed["tail"].dtype == torch.complex64 and crossed["tail"].shape == tcarry["tail"].shape
    assert crossed["demod_state"]["demod"].shape == tcarry["demod_state"]["demod"].shape
    back = to_jax(tcarry, jcarry)
    for b in blocks[2:]:
        jcarry, jy = jbank.step(jcarry, jcplx.from_numpy(b))
        crossed, ty = bank.step(crossed, torch.from_numpy(b))
        back, by = jbank.step(back, jcplx.from_numpy(b))
        tcarry, y = bank.step(tcarry, torch.from_numpy(b))
        assert err_db(np.asarray(jy), ty.numpy()) <= AUDIO_DB
        assert err_db(y.numpy(), np.asarray(by)) <= AUDIO_DB


def test_sequential_tail_carry_crosses(rng):
    """A carry with a sequential tail (a de-emphasis beyond the warm-up
    limit) keeps ``tail_state``, in both packages."""
    fs = 48000.0
    tau = (JB.Deemphasis._MAX_IIR_WARMUP * 4) / (-np.log(1e-7)) / fs
    lp = sps.firwin(33, 0.3).astype(np.float32)
    jchain = JChain([("fir", JB.Fir(lp, 2)), ("demod", JB.QuadFmDemod(gain=1.1)), ("deemph", JB.Deemphasis(fs, tau))])
    jtss = JTSS(jchain, j_make_mesh(8))
    tss = TimeShardedStream(port_chain(jchain), make_mesh(8, device="cpu"))
    blocks = ticks_of(rng, 8192 * 3, 3)
    jcarry = jtss.init_carry()
    jcarry, _ = jtss.step(jcarry, jcplx.from_numpy(blocks[0]))
    crossed = from_jax(jcarry)
    assert set(crossed) == set(tss.init_carry()) == {"state", "tail", "tail_state"}
    for b in blocks[1:]:
        jcarry, jy = jtss.step(jcarry, jcplx.from_numpy(b))
        crossed, ty = tss.step(crossed, torch.from_numpy(b))
        assert err_db(np.asarray(jy), ty.numpy()) <= AUDIO_DB
