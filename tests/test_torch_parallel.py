"""Time sharding on the CPU: ``tpusdr_torch.parallel`` on a
``LocalMesh(device='cpu')`` against the JAX package's ``TimeShardedStream``
on its virtual 8-device CPU mesh (tests/conftest.py), case for case with
tests/test_parallel.py, at its sizes.

Each case runs the same numpy input, made from a seed, through JAX's
sharded stream and the port's, the port's blocks built from the JAX
blocks' numbers (``convert.chain_from_numpy``) or from the same JSON spec.

Tolerances: the port's sharded output against its own unsharded output
at most -100 dB of error energy (JAX's bar, ``assert_shard_stable``); the
port's sharded output against JAX's sharded output within 1e-5 of the
peak where it is a FIR stage's, at most -80 dB where it is audio (after a
discriminator or an IIR).

Which cases come out bit for bit on the CPU, sharded against unsharded
within the port: the channelizer alone and the channel bank on the 2-D
mesh (``BIT_EXACT``, held to it).  The others differ in the last bits,
because a plain op blocks a shard's length otherwise than the whole
tick's (``ops/fir.fir_extended`` 'auto', the resampler's and the IIR's
matmuls): FIR chains at -141 to -153 dB, the WBFM receiver at -141, the
JSON graph at -146, the graph with its DcBlock tail at -122.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from tests.test_parallel import assert_shard_stable
from tests.test_parallel import run_unsharded as j_run_unsharded
from tests.test_torch_receiver import jax_block_params
from tpusdr.graph import blocks as JB
from tpusdr.graph.chain import Chain as JChain
from tpusdr.graph.graph import build_graph as j_build_graph
from tpusdr.models import receiver as JR
from tpusdr.ops import cplx as jcplx
from tpusdr.parallel.channels import ChannelShardedBank as JBank
from tpusdr.parallel.halo import TimeShardedStream as JTSS
from tpusdr.parallel.mesh import make_mesh as j_make_mesh
from tpusdr_torch import convert
from tpusdr_torch.graph import blocks as TB
from tpusdr_torch.graph.chain import Chain
from tpusdr_torch.graph.graph import build_graph
from tpusdr_torch.ops import osc
from tpusdr_torch.parallel import ChannelShardedBank, TimeShardedStream, make_mesh
from tpusdr_torch.parallel.mesh import LocalMesh

torch.set_num_threads(1)

AUDIO_DB = -80.0
SHARD_DB = -100.0
BIT_EXACT = {"channelizer", "bank_2d"}


@pytest.fixture
def rng():
    return np.random.default_rng(21)


def lp(n=33):
    return sps.firwin(n, 0.3).astype(np.float32)


def crandn(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def fm_wave(n, fs, offset, deviation=75e3):
    t = np.arange(n) / fs
    audio = np.sin(2 * np.pi * 1000 * t)
    return np.exp(1j * (2 * np.pi * offset * t + 2 * np.pi * deviation * np.cumsum(audio) / fs)).astype(np.complex64)


def port_block_params(name, jb):
    if isinstance(jb, JB.Channelizer):
        return name, "Channelizer", dict(num_channels=jb.num_channels, taps=np.asarray(jb.taps))
    name, kind, params = jax_block_params(name, jb)
    if isinstance(jb, JB.FreqShift):
        params["initial_phase"] = jb.initial_phase
    return name, kind, params


def port_chain(jchain):
    """The port's chain holding the JAX chain's numbers."""
    return convert.chain_from_numpy([port_block_params(n, b) for n, b in jchain.blocks])


def j_input(z):
    return jcplx.from_numpy(z) if np.iscomplexobj(z) else jnp.asarray(z)


def t_run_unsharded(chain, z, ticks):
    s = chain.init_state()
    n = z.shape[-1] // ticks
    outs = []
    for i in range(ticks):
        s, y = chain.apply(s, torch.from_numpy(z[..., i * n : (i + 1) * n]))
        outs.append(y.numpy())
    return np.concatenate(outs, axis=-1)


def t_run_sharded(chain, z, ticks, mesh, **kw):
    tss = TimeShardedStream(chain, mesh, **kw)
    carry = tss.init_carry()
    n = z.shape[-1] // ticks
    outs = []
    for i in range(ticks):
        carry, y = tss.step(carry, torch.from_numpy(z[..., i * n : (i + 1) * n]))
        outs.append(y.numpy())
    return np.concatenate(outs, axis=-1)


def j_run(chain, z, ticks, mesh, **kw):
    tss = JTSS(chain, mesh, **kw)
    carry = tss.init_carry()
    n = z.shape[-1] // ticks
    outs = []
    for i in range(ticks):
        carry, y = tss.step(carry, j_input(z[..., i * n : (i + 1) * n]))
        outs.append(jcplx.to_numpy(y) if jcplx.is_pair(y) else np.asarray(y))
    return np.concatenate(outs, axis=-1)


def err_db(ref, got):
    return 10 * np.log10(np.sum(np.abs(ref - got) ** 2) / np.sum(np.abs(ref) ** 2))


def close_to_peak(got, ref, rel=1e-5):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def hold(case, t_shd, t_ref, j_shd, audio):
    """The port's sharded output against its unsharded output (-100 dB,
    bit for bit for the cases in BIT_EXACT) and against JAX's sharded
    output (FIR 1e-5 of peak, audio -80 dB)."""
    assert t_shd.shape == t_ref.shape == j_shd.shape
    assert_shard_stable(t_shd, t_ref, SHARD_DB)
    if case in BIT_EXACT:
        np.testing.assert_array_equal(t_shd, t_ref)
    if audio:
        assert err_db(j_shd, t_shd) <= AUDIO_DB
    else:
        close_to_peak(t_shd, j_shd)


# -- TestTimeSharding ------------------------------------------------------------------


def test_fir_chain_sharded(rng):
    jchain = JChain([("shift", JB.FreqShift(1e6, -123e3)), ("fir", JB.Fir(lp(33), 4)),
                     ("demod", JB.QuadFmDemod(gain=1.3))])
    chain = port_chain(jchain)
    z = crandn(rng, 8 * 1024 * 2)
    hold("fir_chain", t_run_sharded(chain, z, 2, make_mesh(8, device="cpu")), t_run_unsharded(chain, z, 2),
         j_run(jchain, z, 2, j_make_mesh(8)), audio=True)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_shard_counts_agree(rng, shards):
    jchain = JChain([("fir", JB.Fir(lp(17), 2)), ("demod", JB.QuadFmDemod(gain=1.0))])
    chain = port_chain(jchain)
    z = crandn(rng, 4096)
    hold("shard_counts", t_run_sharded(chain, z, 1, make_mesh(shards, device="cpu")),
         t_run_unsharded(chain, z, 1), j_run(jchain, z, 1, j_make_mesh(shards)), audio=True)


@pytest.mark.parametrize("stagewise", [True, False])
def test_wbfm_receiver_sharded(stagewise):
    """The whole WBFM chain over 8 shards, both halo forms (the port's
    Deemphasis warms up in 484 samples, so the chain has no tail)."""
    jchain, _ = JR.fm_receiver(2e6, freq_offset=200e3)
    chain = port_chain(jchain)
    tick = 8 * jchain.granule * max(1, ((1 << 16) // jchain.granule) // 8)
    z = fm_wave(2 * tick, 2e6, 200e3)
    mesh = make_mesh(8, device="cpu")
    tss = TimeShardedStream(chain, mesh, stagewise=stagewise)
    assert tss.tail_chain is None and tss.stagewise is stagewise
    hold("wbfm", t_run_sharded(chain, z, 2, mesh, stagewise=stagewise), t_run_unsharded(chain, z, 2),
         j_run(jchain, z, 2, j_make_mesh(8), stagewise=stagewise), audio=True)


def test_channelizer_sharded(rng):
    jchain = JChain([("chan", JB.Channelizer(8, taps_per_channel=6))])
    chain = port_chain(jchain)
    z = crandn(rng, 8 * 128 * 4)
    hold("channelizer", t_run_sharded(chain, z, 2, make_mesh(4, device="cpu")), t_run_unsharded(chain, z, 2),
         j_run(jchain, z, 2, j_make_mesh(4)), audio=False)


def test_streaming_across_ticks(rng):
    """Many small sharded ticks equal one unsharded pass: the halo carried
    across tick boundaries."""
    jchain = JChain([("fir", JB.Fir(lp(33), 2))])
    chain = port_chain(jchain)
    z = crandn(rng, 8192 * 2)
    hold("streaming", t_run_sharded(chain, z, 4, make_mesh(8, device="cpu")), t_run_unsharded(chain, z, 1),
         j_run(jchain, z, 4, j_make_mesh(8)), audio=False)


def deemph_near_cliff():
    fs = 48000.0
    target = int(JB.Deemphasis._MAX_IIR_WARMUP * 0.97)
    return fs, target / (-np.log(1e-7)) / fs


def test_deemphasis_sharded_near_warmup_cliff(rng):
    """A de-emphasis pole just under the warm-up limit: each shard's halo is
    the whole ~32k-sample warm-up, per-shard length equal to it (the least
    legal tick).  JAX's side is its unsharded chain (its sharded form of
    this case is a slow test)."""
    fs, tau = deemph_near_cliff()
    jblk = JB.Deemphasis(fs, tau)
    chain = port_chain(JChain([("deemph", jblk)]))
    blk = chain.get_block("deemph")
    assert blk.time_shardable and blk.history == jblk.history > 30000
    x = rng.standard_normal(8 * blk.history).astype(np.float32)
    t_shd = t_run_sharded(chain, x, 1, make_mesh(8, device="cpu"))
    assert_shard_stable(t_shd, t_run_unsharded(chain, x, 1), -90.0)  # JAX's bar for this case
    assert err_db(j_run_unsharded(JChain([("deemph", jblk)]), jnp.asarray(x), 1), t_shd) <= AUDIO_DB


def test_deemphasis_beyond_cliff_splits_to_tail(rng):
    """A pole beyond the limit is not time-shardable: it runs in the
    sequential tail on the gathered output."""
    fs = 48000.0
    tau = (JB.Deemphasis._MAX_IIR_WARMUP * 4) / (-np.log(1e-7)) / fs
    jchain = JChain([("fir", JB.Fir(lp(33), 2)), ("demod", JB.QuadFmDemod(gain=1.1)),
                     ("deemph", JB.Deemphasis(fs, tau))])
    chain = port_chain(jchain)
    tss = TimeShardedStream(chain, make_mesh(8, device="cpu"))
    assert [n for n, _ in tss.tail_chain.blocks] == ["deemph"] and "tail_state" in tss.init_carry()
    z = crandn(rng, 8192 * 2)
    hold("deemph_tail", t_run_sharded(chain, z, 2, make_mesh(8, device="cpu")), t_run_unsharded(chain, z, 2),
         j_run(jchain, z, 2, j_make_mesh(8)), audio=True)


def test_rejects_bad_tick():
    """JAX's errors: a tick that the shards do not divide, a shard shorter
    than the halo or than a stage's halo, no shardable prefix, and a
    stagewise Graph."""
    mesh = make_mesh(8, device="cpu")
    chain = Chain([("fir", TB.Fir(lp(9), 2))])
    tss = TimeShardedStream(chain, mesh)
    with pytest.raises(ValueError, match="divisible"):
        tss.step(tss.init_carry(), torch.zeros(1000, dtype=torch.complex64))
    wide = TimeShardedStream(chain, mesh, halo=64)
    with pytest.raises(ValueError, match="smaller than halo"):
        wide.step(wide.init_carry(), torch.zeros(8 * 16, dtype=torch.complex64))
    two = TimeShardedStream(Chain([("fir1", TB.Fir(lp(65), 4)), ("fir2", TB.Fir(lp(129), 1, "FloatComplex"))]), mesh,
                            halo=4)
    with pytest.raises(ValueError, match="stage 'fir2'"):
        two.step(two.init_carry(), torch.zeros(8 * 256, dtype=torch.complex64))
    with pytest.raises(ValueError, match="no time-shardable prefix"):
        TimeShardedStream(Chain([("dc", TB.DcBlock())]), mesh)
    with pytest.raises(ValueError, match="need a Chain"):
        TimeShardedStream(build_graph(graph_spec(1e6)), mesh, stagewise=True)


# -- TestGraphTimeSharding ---------------------------------------------------------------


def graph_spec(fs, with_dc=False):
    """tests/test_parallel.py's graph: Cosine x Multiply -> Fir /4 -> QuadDemod."""
    taps = sps.firwin(65, 0.2).astype(np.float32)
    nodes = {
        "osc": {"type": "Cosine", "sampleRate": fs, "frequency": -1.2e5, "sampleType": "FloatComplex"},
        "mix": {"type": "Multiply"},
        "lp": {"type": "Fir", "taps": [float(v) for v in taps], "decimation": 4},
        "dem": {"type": "QuadDemod", "modulation": "Fm", "sampleRate": fs / 4, "fskDeviation": 60e3},
    }
    conns = [{"source": "osc", "sink": "mix", "sinkPort": 1}, {"source": "mix", "sink": "lp"},
             {"source": "lp", "sink": "dem"}]
    out = "dem"
    if with_dc:
        nodes["dc"] = {"type": "DcBlock"}
        conns.append({"source": "dem", "sink": "dc"})
        out = "dc"
    return {"nodes": nodes, "connections": conns,
            "inputPorts": [{"exposedPort": 0, "mapped": {"node": "mix", "port": 0}}], "outputPort": out}


def test_json_graph_sharded(rng):
    """A JSON graph takes the chain-wide halo; its Cosine source is shifted
    by its output-rate offset."""
    g, jg = build_graph(graph_spec(1e6)), j_build_graph(graph_spec(1e6))
    tss = TimeShardedStream(g, make_mesh(8, device="cpu"))
    assert not tss.stagewise and tss.halo == 68
    z = crandn(rng, 8 * 2048 * 2)
    hold("json_graph", t_run_sharded(g, z, 2, make_mesh(8, device="cpu")), t_run_unsharded(g, z, 2),
         j_run(jg, z, 2, j_make_mesh(8)), audio=True)


def test_graph_nonshardable_tail_split(rng):
    g, jg = build_graph(graph_spec(1e6, with_dc=True)), j_build_graph(graph_spec(1e6, with_dc=True))
    head, tail = g.split_shardable()
    assert tail is not None and [n for n, _ in tail.blocks] == ["dc"]
    assert "dc" not in head.nodes and head.outputs == ["dem"]
    z = crandn(rng, 4 * 4096)
    hold("graph_tail", t_run_sharded(g, z, 2, make_mesh(4, device="cpu")), t_run_unsharded(g, z, 2),
         j_run(jg, z, 2, j_make_mesh(4)), audio=True)


def test_graph_history_and_ratio():
    g = build_graph(graph_spec(1e6))
    # lp: 64 samples at the input rate; dem: 1 sample at fs/4 -> 4
    assert g.history == j_build_graph(graph_spec(1e6)).history == 64 + 4
    assert (g.up, g.down) == (1, 4)


# -- Test2DMesh --------------------------------------------------------------------------


def test_time_sharding_2d_matches_1d(rng):
    jchain = JChain([("fir", JB.Fir(lp(33), 4)), ("demod", JB.QuadFmDemod(gain=1.0))])
    chain = port_chain(jchain)
    z = crandn(rng, 16384)
    mesh2d = make_mesh({"host": 2, "chip": 4}, device="cpu")
    assert mesh2d.size(("host", "chip")) == 8 and mesh2d.size("chip") == 4
    shd = t_run_sharded(chain, z, 2, mesh2d, axis=("host", "chip"))
    np.testing.assert_array_equal(shd, t_run_sharded(chain, z, 2, make_mesh(8, device="cpu")))
    hold("mesh_2d", shd, t_run_unsharded(chain, z, 2),
         j_run(jchain, z, 2, j_make_mesh({"host": 2, "chip": 4}), axis=("host", "chip")), audio=True)


def test_channel_bank_2d_uneven_channels(rng):
    """10 channels over a 2x4 mesh: the padding and the tuple-axis pivot
    against the unsharded bank and JAX's sharded bank."""
    m = 10
    jchan = JB.Channelizer(m, taps_per_channel=6)
    jbank = JBank(jchan, JChain([("demod", JB.QuadFmDemod(gain=1.0))]), j_make_mesh({"host": 2, "chip": 4}),
                  axis=("host", "chip"))
    chan = convert.block_params_from_numpy("Channelizer", dict(num_channels=m, taps=jchan.taps))
    demod = Chain([("demod", TB.QuadFmDemod(gain=1.0))])
    mesh2d = make_mesh({"host": 2, "chip": 4}, device="cpu")
    bank = ChannelShardedBank(chan, demod, mesh2d, axis=("host", "chip"))
    assert (bank.m_pad, bank.local_channels) == (jbank.m_pad, jbank.local_channels) == (16, 2)
    unsharded = Chain([("chan", chan), ("demod", TB.QuadFmDemod(gain=1.0))])
    tick = 8 * bank.chan_chain.granule * 40
    z = crandn(rng, 2 * tick)
    carry, jcarry, s = bank.init_carry(), jbank.init_carry(), unsharded.init_state()
    for i in range(2):
        blk = z[i * tick : (i + 1) * tick]
        carry, a = bank.step(carry, torch.from_numpy(blk))
        jcarry, ja = jbank.step(jcarry, jcplx.from_numpy(blk))
        s, r = unsharded.apply(s, torch.from_numpy(blk))
        assert a.shape == r.shape == (m, tick // m)
        hold("bank_2d", a.numpy(), r.numpy(), np.asarray(ja), audio=True)


# -- TestStagewiseHalo -------------------------------------------------------------------


def test_fir_cascade_matches_unsharded(rng):
    jchain = JChain([("fir1", JB.Fir(lp(65), 4)), ("fir2", JB.Fir(lp(17), 2))])
    chain = port_chain(jchain)
    z = crandn(rng, 8 * 4096)
    mesh = make_mesh(8, device="cpu")
    hold("fir_cascade", t_run_sharded(chain, z, 2, mesh, stagewise=True), t_run_unsharded(chain, z, 2),
         j_run(jchain, z, 2, j_make_mesh(8), stagewise=True), audio=False)


def test_wbfm_receiver_stagewise_three_ticks():
    """Per-stage tails carried across three tick boundaries."""
    jchain, _ = JR.fm_receiver(2e6, freq_offset=200e3)
    chain = port_chain(jchain)
    tick = 8 * chain.granule * max(1, (1 << 16) // (8 * chain.granule))
    z = fm_wave(3 * tick, 2e6, 200e3)
    mesh = make_mesh(8, device="cpu")
    tss = TimeShardedStream(chain, mesh, stagewise=True)
    jtss = JTSS(jchain, j_make_mesh(8), stagewise=True)
    assert [s[:1] + s[2:4] for s in tss._stages] == [s[:1] + s[2:4] for s in jtss._stages]
    assert set(tss.init_carry()["tail"]) == set(jtss.init_carry()["tail"])
    hold("wbfm", t_run_sharded(chain, z, 3, mesh, stagewise=True), t_run_unsharded(chain, z, 3),
         j_run(jchain, z, 3, j_make_mesh(8), stagewise=True), audio=True)


def test_stagewise_halo_is_smaller():
    """A stage's lookback is paid at its own rate: at 20 Msps the per-stage
    halos add up to under a twentieth of the chain-wide 40,000 samples."""
    chain, _ = JR.fm_receiver(20e6, freq_offset=2.5e6)
    tss = TimeShardedStream(port_chain(chain), make_mesh(8, device="cpu"), stagewise=True)
    jtss = JTSS(chain, j_make_mesh(8), stagewise=True)
    assert (tss.halo, tss.tick_granule) == (jtss.halo, jtss.tick_granule) == (40000, 10000)
    assert sum(h for _n, _b, h, _s, _bs in tss._stages) < tss.halo / 20


def test_channelizer_stagewise(rng):
    jchain = JChain([("chan", JB.Channelizer(8, taps_per_channel=6)), ("fir", JB.Fir(lp(17), 1, "FloatComplex"))])
    chain = port_chain(jchain)
    tss = TimeShardedStream(chain, make_mesh(4, device="cpu"), stagewise=True)
    assert tuple(tss.init_carry()["tail"]["fir"].shape) == (8, 16)  # the channel axis before the time axis
    z = crandn(rng, 8 * 128 * 4)
    hold("channelizer_stagewise", t_run_sharded(chain, z, 2, make_mesh(4, device="cpu"), stagewise=True),
         t_run_unsharded(chain, z, 2), j_run(jchain, z, 2, j_make_mesh(4), stagewise=True), audio=False)


# -- the port's own: phases, meshes, capture ---------------------------------------------


@pytest.mark.parametrize("initial", [2 * np.pi * (1 - 1e-7), 0.0], ids=["near_2_32", "at_0"])
@pytest.mark.parametrize("stagewise", [True, False])
def test_shard_phases_wrap(rng, initial, stagewise):
    """Each shard's NCO phase is the carried phase moved by the shard's
    offset, negative for shard 0, in uint32 arithmetic: near the 2^32 wrap
    and at 0 (where shard 0 goes back past it) it equals the phase of the
    unsharded stream at the shard's first sample, as JAX's does."""
    jchain = JChain([("shift", JB.FreqShift(1e6, -123e3, initial_phase=initial)), ("fir", JB.Fir(lp(33), 4))])
    chain = port_chain(jchain)
    tss = TimeShardedStream(chain, make_mesh(8, device="cpu"), stagewise=stagewise)
    state = tss.init_carry()["state"]
    inc, p0 = int(jchain.get_block("shift").inc), osc.radians_to_u32(initial)
    halo = tss._stages[0][2] if stagewise else tss.halo
    for i in range(8):
        got = int(tss.chain.shift_state(state, i * 512 - halo)["shift"])
        assert got == (p0 + inc * (i * 512 - halo)) % (1 << 32)
    z = crandn(rng, 8 * 512 * 2)
    hold("phase", t_run_sharded(chain, z, 2, make_mesh(8, device="cpu"), stagewise=stagewise),
         t_run_unsharded(chain, z, 2), j_run(jchain, z, 2, j_make_mesh(8), stagewise=stagewise), audio=False)


def test_local_mesh_moves_equal_their_definitions(rng):
    """shift_right, all_to_all and gather on a LocalMesh against their
    definitions (JAX's ppermute ring, tiled all_to_all, concatenation)."""
    mesh = make_mesh(4, device="cpu")
    parts = [torch.from_numpy(crandn(rng, 8 * 6).reshape(8, 6)) for _ in range(4)]
    assert [p is q for p, q in zip(mesh.shift_right(parts), parts[-1:] + parts[:-1])] == [True] * 4
    out = mesh.all_to_all(parts, split_axis=0, concat_axis=1)
    for j in range(4):
        np.testing.assert_array_equal(out[j].numpy(), np.concatenate([p.numpy()[2 * j : 2 * j + 2] for p in parts], 1))
    np.testing.assert_array_equal(mesh.gather(parts, dim=-1).numpy(), np.concatenate([p.numpy() for p in parts], -1))
    assert list(mesh.local_shards()) == [0, 1, 2, 3] and (mesh.rank, mesh.world_size) == (0, 1)


def test_make_mesh_needs_a_card_or_the_cpu(monkeypatch):
    """Without a card a mesh is made only on the CPU by name, and the
    sharded step is eager there: capture=True raises, as StreamRunner's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="no CUDA device"):
        make_mesh(8)
    mesh = make_mesh(8, device="cpu")
    assert isinstance(mesh, LocalMesh) and mesh.device.type == "cpu"
    chain = Chain([("fir", TB.Fir(lp(9), 2))])
    assert not TimeShardedStream(chain, mesh).capture
    with pytest.raises(ValueError, match="capture=True"):
        TimeShardedStream(chain, mesh, capture=True)
    with pytest.raises(ValueError, match="capture=True"):
        ChannelShardedBank(TB.Channelizer(8, taps_per_channel=6), Chain([("d", TB.QuadFmDemod(gain=1.0))]),
                           mesh, capture=True)
    with pytest.raises(ValueError, match="not"):
        mesh.size("time")
