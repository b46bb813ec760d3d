"""The runner's compiled step on the CPU: the carried NCO phase as a 0-d
int64 tensor against the JAX package's uint32 phase, every receiver's
carry made of tensors only, and the in-place step that a CUDA graph
records (``graph/runner.py``: ``step_in_place``) run eagerly against the
functional ``apply``.

Tolerances: phases exactly (uint32 arithmetic on both sides); block
outputs within 1e-5 of the output's peak, discriminator outputs within
1e-5 * gain (the bars of tests/test_torch_receiver.py); the in-place step
bit for bit against ``apply`` (the same operations on the same tensors);
chain audio from a converted JAX carry at <= -80 dB against JAX.  The
card's side (captured against eager, bit for bit) is in
tests/test_torch_cuda.py.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch
from torch.utils import _pytree as pytree

from tpusdr.graph import blocks as JB
from tpusdr.models import receiver as JR
from tpusdr.ops import cplx as jcplx
from tpusdr_torch import convert
from tpusdr_torch.graph import blocks as TB
from tpusdr_torch.graph.block import Block
from tpusdr_torch.graph.checkpoint import load_state
from tpusdr_torch.graph.graph import build_graph
from tpusdr_torch.graph.queues import MergedRunner
from tpusdr_torch.graph.runner import CapturedStep, StreamRunner, collector_held, static_copy, step_in_place
from tpusdr_torch.models import multichannel
from tpusdr_torch.models import receiver as TR
from tpusdr_torch.ops import osc

torch.set_num_threads(1)

U32 = 1 << 32
TICKS = 6
NEAR_WRAP = 2 * np.pi * (1 - 1e-7)  # an initial phase 430 counts short of 2^32


@pytest.fixture
def rng():
    return np.random.default_rng(41)


def fm_tone(rng, n, fs, offset, deviation=75e3):
    t = np.arange(n) / fs
    ph = 2 * np.pi * offset * t + 2 * np.pi * deviation * np.cumsum(np.sin(2 * np.pi * 1e3 * t)) / fs
    noise = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return (0.9 * np.exp(1j * ph) + 0.01 * noise).astype(np.complex64)


def np_out(y):
    return jcplx.to_numpy(y) if isinstance(y, jcplx.Complex) else np.asarray(y)


def close_to_peak(got, ref, rel=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def err_db(ref, got):
    return 10 * np.log10(np.sum(np.abs(ref - got) ** 2) / np.sum(np.abs(ref) ** 2))


def phase_of(state):
    return state["phase"] if isinstance(state, dict) else state


def tensor_leaves_only(state):
    leaves = pytree.tree_flatten(state)[0]
    return all(isinstance(leaf, torch.Tensor) for leaf in leaves)


# -- (a) the carried phase against JAX's, across the 2^32 wrap --------------------------


def _pair(kind):
    """(JAX block, port block, tick length, input maker, output bar)."""
    if kind == "FreqShift":
        args = (2e6, -300e3, NEAR_WRAP)
        return JB.FreqShift(*args), TB.FreqShift(*args), 3000, "complex", 1e-5
    if kind == "CosineMix":
        args = (48e3, -800.0, NEAR_WRAP)
        return JB.CosineMix(*args), TB.CosineMix(*args), 4800, "real", 1e-5
    if kind == "CosineSource":
        args = (2e6, 300e3, "FloatComplex", 0.7, NEAR_WRAP)
        return JB.CosineSource(*args), TB.CosineSource(*args), 5000, None, 1e-5
    if kind == "FreqShiftFir":
        t = sps.firwin(89, 0.05).astype(np.float32)
        return (JB.FreqShiftFir(1e6, -150e3, t, 8, initial_phase=NEAR_WRAP),
                TB.FreqShiftFir(1e6, -150e3, t, 8, initial_phase=NEAR_WRAP), 8192, "complex", 1e-5)
    if kind == "FusedFmDemod rows":
        t = sps.firwin(65, 0.1).astype(np.float32)
        return (JB.FusedFmDemod(1e6, -150e3, t, 8, gain=1.7), TB.FusedFmDemod(1e6, -150e3, t, 8, gain=1.7),
                48 * 1024, "fm rows", 1e-5 * 1.7)
    t = sps.firwin(728, 0.007).astype(np.float32)
    return (JB.FusedFmDemod(2e6, -100e3, t, 66, gain=1.7), TB.FusedFmDemod(2e6, -100e3, t, 66, gain=1.7),
            66 * 500, "fm fused", 1e-5 * 1.7)


PHASE_BLOCKS = ["FreqShift", "CosineMix", "CosineSource", "FreqShiftFir", "FusedFmDemod rows",
                "FusedFmDemod fm_fused"]


@pytest.mark.parametrize("kind", PHASE_BLOCKS)
def test_carried_phase_equals_jax_across_the_wrap(rng, kind):
    """Six ticks, each advancing the phase by inc * n, many times 2^32:
    the port's phase is a 0-d int64 tensor equal to JAX's uint32 after
    every tick, and the outputs stay within the bars in use."""
    jb, tb, n, make, bar = _pair(kind)
    js, ts = jb.init_state(), tb.init_state()
    p = phase_of(ts)
    assert p.dtype == torch.int64 and p.dim() == 0 and osc.is_phase(p)
    assert int(p) == int(phase_of(js))
    assert tb.inc * n >= U32  # one tick wraps the accumulator
    if kind == "FusedFmDemod rows":
        assert tb._rows_capable
    elif kind == "FusedFmDemod fm_fused":
        assert not tb._rows_capable
    for _ in range(TICKS):
        if make is None:
            js, jy = jb.generate(js, n)
            ts, ty = tb.generate(ts, n)
        else:
            if make == "real":
                z = rng.standard_normal(n).astype(np.float32)
                jz = jnp.asarray(z)
            else:
                fs, off, dev = {"complex": (1e6, 150e3, 75e3), "fm rows": (1e6, 150e3, 20e3),
                                "fm fused": (2e6, 100e3, 5e3)}[make]
                z = fm_tone(rng, n, fs, off, dev)
                jz = jcplx.from_numpy(z)
            js, jy = jb.apply(js, jz)
            ts, ty = tb.apply(ts, torch.from_numpy(z))
        p = phase_of(ts)
        assert p.dtype == torch.int64 and p.dim() == 0 and osc.is_phase(p)
        assert int(p) == int(phase_of(js))
        ref = np_out(jy)
        if kind.startswith("FusedFmDemod"):
            np.testing.assert_allclose(ty.numpy(), ref, rtol=0, atol=bar)  # 1e-5 * gain
        else:
            close_to_peak(ty.numpy(), ref, bar)


# -- (b) shift_state and advance_state ----------------------------------------------------


@pytest.mark.parametrize("kind", PHASE_BLOCKS)
@pytest.mark.parametrize("offset", [7, 10**9 + 5, -12345, 2**31 - 1])
def test_shift_and_advance_state_equal_jax(kind, offset):
    """The closed-form hooks that time sharding uses: the same phase as
    JAX's for offsets either way and past 2^31 samples."""
    jb, tb, *_ = _pair(kind)
    js, ts = jb.init_state(), tb.init_state()
    got = tb.shift_state(ts, offset)
    want = jb.shift_state(js, offset)
    assert osc.is_phase(phase_of(got)) and int(phase_of(got)) == int(phase_of(want))
    if offset >= 0:
        got = tb.advance_state(ts, offset)
        want = jb.advance_state(js, offset)
        assert osc.is_phase(phase_of(got)) and int(phase_of(got)) == int(phase_of(want))
    if isinstance(ts, dict):  # the other carries pass through untouched
        assert all(got[k] is ts[k] for k in ts if k != "phase")


# -- (c) every receiver's carry is tensors only -------------------------------------------


def wbfm_graph_spec(fs=2e6, offset=300e3):
    """The WBFM receiver as a reference-schema JSON graph (the card tests'
    shape at 2 Msps): Cosine x Multiply -> Fir (K4) -> QuadDemod ->
    Deemphasis -> Resampler."""
    taps = sps.firwin(55, 0.1).astype(np.float32).tolist()
    return {
        "nodes": {
            "osc": {"type": "Cosine", "sampleRate": fs, "frequency": -offset, "sampleType": "FloatComplex"},
            "mix": {"type": "Multiply"},
            "rf.fir": {"type": "Fir", "taps": taps, "decimation": 5, "mode": "pallas"},
            "dem": {"type": "QuadDemod", "modulation": "Fm", "sampleRate": fs / 5, "fskDeviation": 75e3},
            "de": {"type": "Deemphasis", "sampleRate": fs / 5, "tau": 75e-6},
            "rs": {"type": "Resampler", "up": 3, "down": 25},
        },
        "connections": [
            {"source": "osc", "sink": "mix", "sinkPort": 1},
            {"source": "mix", "sink": "rf.fir"},
            {"source": "rf.fir", "sink": "dem"},
            {"source": "dem", "sink": "de"},
            {"source": "de", "sink": "rs"},
        ],
        "inputPorts": [{"exposedPort": 0, "mapped": {"node": "mix", "port": 0}}],
        "outputPort": "rs",
    }


def fm_ticks(n, fs, off, dev=75e3):
    return lambda rng: torch.from_numpy(fm_tone(rng, n, fs, off, dev))


def am_words(n):
    return lambda rng: torch.from_numpy(rng.integers(-2**15, 2**15, n).astype(np.int16))


def small_bank():
    bank, _ = multichannel.fm_channel_bank(1.024e6, 8, 16000.0)
    return bank, fm_ticks(bank.granule * 16, 1.024e6, 256e3, 20e3)


#: label -> () -> (block, tick maker): every receiver at a small tick
CONFIGS = {
    "wbfm": lambda: (TR.fm_receiver(2e6, 300e3, TR.WBFM)[0], fm_ticks(40000, 2e6, 300e3)),
    "wbfm fused": lambda: (TR.fm_receiver(2e6, 300e3, TR.WBFM, use_fused=True)[0], fm_ticks(128000, 2e6, 300e3)),
    "nbfm fused": lambda: (TR.fm_receiver(2e6, 100e3, TR.NBFM, use_fused=True)[0],
                           fm_ticks(33000, 2e6, 100e3, 5e3)),
    "am": lambda: (TR.am_receiver(2e6, 100e3, input_format="int8")[0], am_words(40000)),
    "am k4": lambda: (TR.am_receiver(2e6, 100e3, input_format="int8", fir_mode="pallas", fold_shift=False)[0],
                      am_words(40000)),
    "digital": lambda: (TR.digital_receiver()[0], fm_ticks(12000, 1e6, 450e3, 3e3)),
    "bank": small_bank,
    "json graph": lambda: (build_graph(wbfm_graph_spec()), fm_ticks(40000, 2e6, 300e3)),
}


@pytest.mark.parametrize("label", CONFIGS)
def test_every_receiver_carries_tensors_only(rng, label):
    """No leaf of a receiver's carry, fresh or after a tick, is a host
    value a captured graph would freeze."""
    block, make = CONFIGS[label]()
    state = block.init_state()
    assert tensor_leaves_only(state)
    static_copy(block, state)  # the capture guard lets it through
    state, _ = block.apply(state, make(rng))
    assert tensor_leaves_only(state)


# -- (d) the in-place step equals apply ---------------------------------------------------


@pytest.mark.parametrize("label", CONFIGS)
def test_step_in_place_equals_apply(rng, label):
    """The step a CUDA graph records, run eagerly on the CPU (static
    state, each new leaf copied back into it), gives the functional
    apply's stream and carry bit for bit over 8 ticks; the static phases
    keep their mark."""
    block, make = CONFIGS[label]()
    ticks = [make(rng) for _ in range(8)]
    state = block.init_state()
    static = static_copy(block, block.init_state())
    static_x = torch.empty_like(ticks[0])
    static_leaves = pytree.tree_flatten(static)[0]
    for x in ticks:
        state, want = block.apply(state, x)
        static_x.copy_(x)
        got = step_in_place(block, static, static_x)
        assert torch.equal(got, want)
    assert pytree.tree_flatten(static)[0] == static_leaves  # the same buffers, written in place
    for a, b in zip(pytree.tree_flatten(static)[0], pytree.tree_flatten(state)[0]):
        assert torch.equal(a, b) and osc.is_phase(a) == osc.is_phase(b)


# -- (e) the guards ------------------------------------------------------------------------


class HostCounter(Block):
    """A block that carries a Python int, which a graph would freeze."""

    def init_state(self, batch_shape=(), device=None):
        return {"count": 0}

    def apply(self, state, x):
        return {"count": state["count"] + x.shape[-1]}, x


def test_a_python_scalar_leaf_raises_at_capture():
    """The first tick of a shape runs eager; the capture of the second
    refuses the host leaf, naming the block and the leaf, before any
    device call."""
    step = CapturedStep(HostCounter())
    x = torch.zeros(16, dtype=torch.complex64)
    state, _ = step(HostCounter().init_state(), x)
    assert state == {"count": 16}
    with pytest.raises(TypeError, match=r"HostCounter: state leaf \['count'\] is a int, not a tensor"):
        step(state, x)
    chain, _ = TR.fm_receiver(2e6, 300e3, TR.WBFM)
    with pytest.raises(TypeError, match=r"Chain\(shiftfir, demod, deemph, audio\): state leaf \['shiftfir'\]\['phase'\]"):
        static_copy(chain, {**chain.init_state(), "shiftfir": {"tail": torch.zeros(54), "phase": 5}})


@pytest.mark.parametrize("was_on", [True, False])
def test_collector_held_turns_the_collector_off_and_back(was_on):
    """``collector_held``, which a capture runs inside: the garbage
    collector off within it and as it was after, a raise included."""
    saved = gc.isenabled()
    (gc.enable if was_on else gc.disable)()
    try:
        with collector_held():
            assert not gc.isenabled()
        assert gc.isenabled() is was_on
        with pytest.raises(RuntimeError, match="capture failed"), collector_held():
            raise RuntimeError("capture failed")
        assert gc.isenabled() is was_on
    finally:
        (gc.enable if saved else gc.disable)()


def test_capture_true_on_the_cpu_raises():
    chain, _ = TR.fm_receiver(2e6, 300e3, TR.WBFM)
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        StreamRunner(chain, device="cpu", capture=True)
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        MergedRunner({"a": chain}, capture=True)
    runner = StreamRunner(chain, device="cpu")
    assert runner.capture is False and runner._step == chain.apply


# -- (f) carries from JAX and from old checkpoints continue the stream ---------------------


def test_converted_jax_state_continues_to_the_same_audio(rng):
    """Two WBFM ticks in JAX, the carry taken across (uint32 phase -> the
    marked int64 tensor), two more in the port: the audio JAX gives on
    those ticks, and the phase it ends on; the carry goes back as uint32."""
    jchain, _ = JR.fm_receiver(2e6, 300e3, JR.WBFM)
    tchain, _ = TR.fm_receiver(2e6, 300e3, TR.WBFM)
    ticks = [fm_tone(rng, 40000, 2e6, 300e3) for _ in range(4)]
    js = jchain.init_state()
    for z in ticks[:2]:
        js, _ = jchain.apply(js, jcplx.from_numpy(z))
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js))
    assert osc.is_phase(ts["shiftfir"]["phase"]) and ts["shiftfir"]["phase"].dtype == torch.int64
    for z in ticks[2:]:
        js, jy = jchain.apply(js, jcplx.from_numpy(z))
        ts, ty = tchain.apply(ts, torch.from_numpy(z))
        assert err_db(np.asarray(jy), ty.numpy()) <= -80.0
    back = convert.state_to_numpy(ts)
    assert back["shiftfir"]["phase"].dtype == np.uint32
    assert int(back["shiftfir"]["phase"]) == int(js["shiftfir"]["phase"])


def test_checkpoint_with_an_int_phase_continues_to_the_same_audio(rng, tmp_path):
    """A checkpoint written while phases were Python ints (the phase a
    uint32 scalar, as ``save_state`` stored an int) loads into the tensor
    phase and continues the stream bit for bit."""
    chain, _ = TR.fm_receiver(2e6, 300e3, TR.WBFM)
    ticks = [torch.from_numpy(fm_tone(rng, 40000, 2e6, 300e3)) for _ in range(4)]
    state, want = chain.init_state(), []
    for i, x in enumerate(ticks):
        if i == 2:
            leaves = {"shiftfir/tail": state["shiftfir"]["tail"].numpy(),
                      "shiftfir/phase": np.asarray(int(state["shiftfir"]["phase"]), np.uint32),
                      "demod": state["demod"].numpy(), "deemph": state["deemph"].numpy(),
                      "audio": state["audio"].numpy()}
            np.savez(tmp_path / "old.npz", **leaves)
        state, y = chain.apply(state, x)
        want.append(y)
    resumed = load_state(str(tmp_path / "old.npz"), chain.init_state())
    assert osc.is_phase(resumed["shiftfir"]["phase"])
    for x, ref in zip(ticks[2:], want[2:]):
        resumed, y = chain.apply(resumed, x)
        assert torch.equal(y, ref)
