"""The channel-sharded bank on the CPU: ``tpusdr_torch.parallel.
ChannelShardedBank`` on a ``LocalMesh(device='cpu')`` against the JAX
package's bank on its virtual CPU mesh, case for case with
tests/test_channels_sharded.py, at its sizes.

The port's blocks hold the JAX blocks' numbers (``convert``).  Tolerances:
the port's sharded audio against its own unsharded chain at most -100 dB
of error energy (JAX's bar), and bit for bit on the CPU (the channelizer
runs the same frames, and each channel's demod the same samples); against
JAX's sharded audio at most -80 dB; the channelizer's frames within 1e-5
of the peak.
"""

import numpy as np
import pytest
import torch

from tests.test_channels_sharded import build as j_build
from tests.test_parallel import assert_shard_stable
from tpusdr.ops import cplx as jcplx
from tpusdr.parallel.channels import ChannelShardedBank as JBank
from tpusdr.parallel.mesh import make_mesh as j_make_mesh
from tpusdr_torch import convert
from tpusdr_torch.graph import blocks as TB
from tpusdr_torch.graph.chain import Chain
from tpusdr_torch.models import multichannel
from tpusdr_torch.parallel import ChannelShardedBank, make_mesh

torch.set_num_threads(1)

AUDIO_DB = -80.0


@pytest.fixture
def rng():
    return np.random.default_rng(33)


def crandn(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def err_db(ref, got):
    return 10 * np.log10(np.sum(np.abs(ref - got) ** 2) / np.sum(np.abs(ref) ** 2))


def port_bank_blocks(jchan, jdemod):
    """The port's channelizer and demod chain holding the JAX blocks' numbers."""
    chan = convert.block_params_from_numpy("Channelizer", dict(num_channels=jchan.num_channels, taps=jchan.taps))
    dm, de, au = (jdemod.get_block(n) for n in ("demod", "deemph", "audio"))
    demod = convert.chain_from_numpy([
        ("demod", "QuadFmDemod", dict(gain=dm.gain)),
        ("deemph", "Deemphasis", dict(sample_rate=de.sample_rate, tau=de.tau, a=de.a, b=de.b)),
        ("audio", "Resampler", dict(up=au.up, down=au.down, taps=np.asarray(au.taps))),
    ])
    return chan, demod


def run_three(m, shards, total, ticks, rng):
    """(port sharded, port unsharded, JAX sharded) audio over ``ticks``."""
    jchan, jdemod, _ = j_build(m=m)
    chan, demod = port_bank_blocks(jchan, jdemod)
    bank = ChannelShardedBank(chan, demod, make_mesh(shards, device="cpu"))
    jbank = JBank(jchan, jdemod, j_make_mesh(shards))
    full = Chain([("chan", chan)] + demod.blocks)
    z = crandn(rng, total)
    n = total // ticks
    carry, jcarry, s = bank.init_carry(), jbank.init_carry(), full.init_state()
    outs = ([], [], [])
    for i in range(ticks):
        blk = z[i * n : (i + 1) * n]
        carry, a = bank.step(carry, torch.from_numpy(blk))
        s, r = full.apply(s, torch.from_numpy(blk))
        jcarry, ja = jbank.step(jcarry, jcplx.from_numpy(blk))
        for o, v in zip(outs, (a.numpy(), r.numpy(), np.asarray(ja))):
            o.append(v)
    return bank, *(np.concatenate(o, axis=-1) for o in outs)


def hold(shd, ref, jshd):
    assert shd.shape == ref.shape == jshd.shape
    assert_shard_stable(shd, ref)
    np.testing.assert_array_equal(shd, ref)
    assert err_db(jshd, shd) <= AUDIO_DB


def test_matches_unsharded(rng):
    bank, shd, ref, jshd = run_three(8, 4, 8 * 128 * 4, 2, rng)
    assert shd.shape == (8, 8 * 128 * 4 // 8 // 2)
    hold(shd, ref, jshd)


def test_uneven_channels_are_padded(rng):
    """6 channels over 4 shards: padded to 8 with dead channels, which the
    audio drops."""
    bank, shd, ref, jshd = run_three(6, 4, 6 * 4 * 6 * 40, 2, rng)
    assert (bank.m_pad, bank.local_channels) == (8, 2)
    assert tuple(bank.init_carry()["demod_state"]["demod"].shape)[0] == 8
    hold(shd, ref, jshd)


def test_eight_way(rng):
    _, shd, ref, jshd = run_three(16, 8, 16 * 64 * 8, 1, rng)
    hold(shd, ref, jshd)


def test_halo_and_granule_equal_jax():
    """The 64-channel bank of the card's smoke: a 768-sample halo (12 frames
    dropped), a 64-sample granule, so ticks of 2,096,640 split over 4
    shards (524,160 each) and over 5 (64 channels padded to 65)."""
    chain, _ = multichannel.fm_channel_bank(20.48e6, 64, 16000.0)
    chan = chain.get_block("channelizer")
    demod = Chain(chain.blocks[1:])
    for shards, m_pad in ((4, 64), (5, 65)):
        bank = ChannelShardedBank(chan, demod, make_mesh(shards, device="cpu"))
        assert (bank.halo, bank.skip, bank.chan_chain.granule, bank.m_pad) == (768, 12, 64, m_pad)
        assert 2_096_640 % (shards * bank.chan_chain.granule) == 0
    with pytest.raises(ValueError, match="divisible"):
        bank.step(bank.init_carry(), torch.zeros(64 * 5 * 7 + 1, dtype=torch.complex64))
    with pytest.raises(ValueError, match="halo"):
        bank.step(bank.init_carry(), torch.zeros(64 * 5 * 2, dtype=torch.complex64))


def test_two_stations_through_the_sharded_bank():
    """Two FM stations through fm_channel_bank's chain split as
    (blocks[0], Chain(blocks[1:])) over 5 shards (dead channels on the
    last): each decodes in its channel, with no trace of the other."""
    from tests.test_torch_channelizer import tone_snr, two_station_ticks

    fs, m = 1.024e6, 8
    chain, info = multichannel.fm_channel_bank(fs, m, 16000.0)
    bank = ChannelShardedBank(chain.blocks[0][1], Chain(chain.blocks[1:]), make_mesh(5, device="cpu"))
    tick = 5 * bank.chan_chain.granule * 64
    carry, outs = bank.init_carry(), []
    for z in two_station_ticks(fs, m, 6, tick, 32e3, 2, 5, 900.0, 1300.0):
        carry, a = bank.step(carry, torch.as_tensor(z))
        outs.append(a.numpy())
    audio = np.concatenate(outs, axis=-1)
    half = audio.shape[-1] // 2
    assert audio.shape[0] == m and bank.m_pad == 10
    for k, fa in ((2, 900.0), (5, 1300.0)):
        amp, snr = tone_snr(audio[k, half:], fa, info["audio_rate"])
        assert snr > 30.0, (k, snr)
    cross, _ = tone_snr(audio[5, half:], 900.0, info["audio_rate"])
    assert cross < 0.1 * tone_snr(audio[5, half:], 1300.0, info["audio_rate"])[0]


def test_bank_is_exact_on_the_channel_axis(rng):
    """The pivot only regroups frames: the bank with a magnitude stage for
    its demod gives |channelizer frames|, within 1e-5 of the peak of JAX's
    channelizer's."""
    jchan, _, _ = j_build(m=8)
    chan = convert.block_params_from_numpy("Channelizer", dict(num_channels=8, taps=jchan.taps))
    bank = ChannelShardedBank(chan, Chain([("copy", TB.Magnitude())]), make_mesh(4, device="cpu"))
    z = crandn(rng, 8 * 128 * 4)
    _, a = bank.step(bank.init_carry(), torch.from_numpy(z))
    _, jy = jchan.apply(jchan.init_state(), jcplx.from_numpy(z))
    ref = np.abs(jcplx.to_numpy(jy))
    np.testing.assert_allclose(a.numpy(), ref, rtol=0, atol=1e-5 * ref.max())
