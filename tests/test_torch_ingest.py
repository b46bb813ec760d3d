"""Sharded ingest and the distributed mesh on the CPU.

``tpusdr_torch.parallel.ShardedFileIngest`` against the JAX package's on
the same capture (tests/test_ingest.py's cases, at its sizes), and the
``DistMesh`` back end over ``torch.distributed`` with gloo:

  * at world size 1 in this process (nothing goes over the wire), equal
    to a ``LocalMesh`` bit for bit;
  * in two processes of two shards each and in four of one (marker
    ``multiprocess``), each reading only its byte ranges of the capture,
    or only its own segment of it: the time-sharded chain in both halo
    forms and the channel bank equal the single-process ``LocalMesh``
    result bit for bit, and the unsharded chain within -100 dB (JAX's
    bar).  The workers are this file run as a script; each runs under a
    time limit, and the process group meets through a ``FileStore`` under
    the test's directory (no port).

Tolerances against JAX: FIR outputs within 1e-5 of the peak, audio at
most -80 dB of error energy.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.signal as sps
import torch

from tpusdr_torch.graph import blocks as TB
from tpusdr_torch.graph.chain import Chain
from tpusdr_torch.parallel import ChannelShardedBank, TimeShardedStream, make_mesh
from tpusdr_torch.parallel.ingest import ShardedFileIngest
from tpusdr_torch.parallel.mesh import DistMesh, LocalMesh

torch.set_num_threads(1)

TICK = 4096
N_TICKS = 3
WORKER_TIMEOUT_S = 120


def fir_taps(n=33):
    return sps.firwin(n, 0.3).astype(np.float32)


def fm_chain():
    return Chain([("fir", TB.Fir(fir_taps(), 2)), ("demod", TB.QuadFmDemod(gain=1.0))])


def bank_blocks():
    from tpusdr_torch.ops import demod

    m = 8
    chan = TB.Channelizer(m, taps_per_channel=6)
    gain = demod.quad_fm_demod_gain(1.0 / m, 1.0 / m)
    return chan, Chain([("demod", TB.QuadFmDemod(gain=gain)), ("deemph", TB.Deemphasis(1.0 / m, 75.0)),
                        ("audio", TB.Resampler(1, 2))])


def capture(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def run_all(mesh, ticks, bank_ticks):
    """The chain in both halo forms and the bank over ``mesh``; each tick is
    this process's part.  Returns the outputs and rank 0's last carries.
    Each output is cloned: on a card a LocalMesh step is captured, and its
    outputs are the graph's buffers, which the next step overwrites."""
    out = {}
    for form, stagewise in (("stagewise", True), ("chainwide", False)):
        tss = TimeShardedStream(fm_chain(), mesh, stagewise=stagewise)
        carry, ys = tss.init_carry(), []
        for x in ticks:
            carry, y = tss.step(carry, x)
            ys.append(y.clone())
        out[form] = torch.cat(ys).cpu().numpy()
        out[form + "_tail"] = (torch.cat(list(carry["tail"].values())) if stagewise else carry["tail"]).cpu().numpy()
    bank = ChannelShardedBank(*bank_blocks(), mesh)
    carry, audio = bank.init_carry(), []
    for x in bank_ticks:
        carry, a = bank.step(carry, x)
        audio.append(a.clone())
    out["bank"] = torch.cat(audio, dim=-1).cpu().numpy()
    out["bank_state"] = carry["demod_state"]["deemph"].cpu().numpy()
    return out


def mesh_moves(mesh):
    """shift_right, all_to_all and gather of 4 shards' seeded parts; the
    process's shards only."""
    rng = np.random.default_rng(3)
    parts = [torch.from_numpy(capture(rng, 8 * 5).reshape(8, 5)).to(mesh.device) for _ in range(4)]
    mine = [parts[i] for i in mesh.local_shards()]
    return (torch.stack(mesh.shift_right(mine)).cpu().numpy(), torch.stack(mesh.all_to_all(mine, 0, 1)).cpu().numpy(),
            mesh.gather(mine, dim=-1).cpu().numpy())


# -- tests/test_ingest.py's cases ---------------------------------------------------


@pytest.mark.parametrize("fmt", ["cf32", "int16"])
def test_ticks_match_file(tmp_path, fmt):
    """Every tick on a LocalMesh is the whole global tick, as JAX's global
    array of the same ticks."""
    from tpusdr.ops import cplx as jcplx
    from tpusdr.parallel.ingest import ShardedFileIngest as JIngest
    from tpusdr.parallel.mesh import make_mesh as j_make_mesh

    rng = np.random.default_rng(0)
    path = str(tmp_path / f"cap.{fmt}")
    z = capture(rng, 4096)
    if fmt == "cf32":
        z.tofile(path)
        want = z
    else:
        raw = rng.integers(-32768, 32768, size=2 * 4096, dtype=np.int16)
        raw.tofile(path)
        want = (raw[0::2] / 32768.0 + 1j * raw[1::2] / 32768.0).astype(np.complex64)
    ing = ShardedFileIngest(path, make_mesh(8, device="cpu"), tick_samples=2048, input_format=fmt)
    assert ing.num_ticks == 2 and (ing.process_index, ing.num_processes, ing.shards_per_process) == (0, 1, 8)
    ticks = list(ing.ticks())
    assert all(t.dtype == torch.complex64 and t.device.type == "cpu" for t in ticks)
    got = np.concatenate([t.numpy() for t in ticks])
    np.testing.assert_array_equal(got, want)
    jing = JIngest(path, j_make_mesh(8), tick_samples=2048, input_format=fmt)
    np.testing.assert_array_equal(got, np.concatenate([jcplx.to_numpy(t) for t in jing.ticks()]))


def test_int8_ingest_feeds_sharded_chain(tmp_path):
    """int8 words from the file through the sharded FIR, against the
    unsharded chain (-100 dB) and JAX's ingest and sharded chain (1e-5 of
    the peak)."""
    from tpusdr.graph import blocks as JB
    from tpusdr.graph.chain import Chain as JChain
    from tpusdr.ops import cplx as jcplx
    from tpusdr.parallel.halo import TimeShardedStream as JTSS
    from tpusdr.parallel.ingest import ShardedFileIngest as JIngest
    from tpusdr.parallel.mesh import make_mesh as j_make_mesh

    path = str(tmp_path / "cap.iq")
    raw = np.random.default_rng(1).integers(-128, 128, size=2 * 8192, dtype=np.int8)
    raw.tofile(path)
    taps = sps.firwin(17, 0.3).astype(np.float32)
    chain = Chain([("fir", TB.Fir(taps, 2))])
    tss = TimeShardedStream(chain, make_mesh(4, device="cpu"))
    carry, outs = tss.init_carry(), []
    for x in ShardedFileIngest(path, make_mesh(4, device="cpu"), 4096, input_format="int8").ticks():
        carry, y = tss.step(carry, x)
        outs.append(y.numpy())
    got = np.concatenate(outs)
    f = raw.astype(np.float32) / 128.0
    z = (f[0::2] + 1j * f[1::2]).astype(np.complex64)
    s, ref = chain.init_state(), []
    for i in range(0, len(z), 4096):
        s, y = chain.apply(s, torch.from_numpy(z[i : i + 4096]))
        ref.append(y.numpy())
    ref = np.concatenate(ref)
    assert np.mean(np.abs(got - ref) ** 2) / np.mean(np.abs(ref) ** 2) < 1e-10
    jmesh = j_make_mesh(4)
    jtss = JTSS(JChain([("fir", JB.Fir(taps, 2))]), jmesh)
    jcarry, jouts = jtss.init_carry(), []
    for x in JIngest(path, jmesh, 4096, input_format="int8").ticks():
        jcarry, y = jtss.step(jcarry, x)
        jouts.append(jcplx.to_numpy(y))
    jgot = np.concatenate(jouts)
    np.testing.assert_allclose(got, jgot, rtol=0, atol=1e-5 * np.abs(jgot).max())


def test_ingest_refuses_a_tick_the_shards_do_not_divide(tmp_path):
    path = str(tmp_path / "cap.cf32")
    np.zeros(64, np.complex64).tofile(path)
    with pytest.raises(ValueError, match="not divisible"):
        ShardedFileIngest(path, make_mesh(8, device="cpu"), tick_samples=100)


# -- DistMesh -------------------------------------------------------------------------


def test_dist_mesh_at_world_size_one_equals_local(tmp_path):
    """A gloo group of one process: make_mesh gives a DistMesh that sends
    nothing over the wire, and its streams and moves equal a LocalMesh's
    bit for bit."""
    import torch.distributed as dist

    rng = np.random.default_rng(11)
    z = capture(rng, N_TICKS * TICK)
    ticks = [torch.from_numpy(z[i * TICK : (i + 1) * TICK]) for i in range(N_TICKS)]
    local = LocalMesh({"dev": 4}, "cpu")
    want, want_moves = run_all(local, ticks, ticks), mesh_moves(local)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh(4)
        assert isinstance(mesh, DistMesh) and mesh.device.type == "cpu" and (mesh.rank, mesh.world_size) == (0, 1)
        assert isinstance(make_mesh(), DistMesh) and make_mesh().size() == 1
        got, moves = run_all(mesh, ticks, ticks), mesh_moves(mesh)
    finally:
        dist.destroy_process_group()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for g, w in zip(moves, want_moves):
        np.testing.assert_array_equal(g, w)


def test_dist_mesh_needs_a_process_group():
    with pytest.raises(ValueError, match="process group"):
        DistMesh({"dev": 2})


def segment_path(path, rank):
    return f"{path}.seg{rank}"


def write_segments(z, path, world, tick):
    """Rank r's stripe of every tick, tick-major: the pre-split capture of
    ``segment_of_host``."""
    local = tick // world
    for r in range(world):
        np.concatenate([z[t * tick + r * local : t * tick + (r + 1) * local] for t in range(len(z) // tick)]
                       ).tofile(segment_path(path, r))


@pytest.mark.multiprocess
@pytest.mark.parametrize("world", [2, 4])
def test_gloo_processes_match_single_process(tmp_path, world):
    """gloo processes sharing 4 shards (2 ranks of 2 shards; 4 of 1, where
    the ring's direction shows): each reads only its byte ranges (the
    time-sharded chain, from the whole capture) or only its segment (the
    bank), and every rank's gathered output equals this process's
    LocalMesh(4) run bit for bit; rank 0's carries equal the LocalMesh's,
    and each rank holds its channels' demod state."""
    rng = np.random.default_rng(7)
    path = str(tmp_path / "cap.cf32")
    z = capture(rng, N_TICKS * TICK)
    z.tofile(path)
    write_segments(z, path, world, TICK)
    ticks = [torch.from_numpy(z[i * TICK : (i + 1) * TICK]) for i in range(N_TICKS)]
    want, want_moves = run_all(LocalMesh({"dev": 4}, "cpu"), ticks, ticks), mesh_moves(LocalMesh({"dev": 4}, "cpu"))
    chain = fm_chain()
    s, ref = chain.init_state(), []
    for x in ticks:
        s, y = chain.apply(s, x)
        ref.append(y.numpy())
    ref = np.concatenate(ref)
    from tests.test_parallel import assert_shard_stable

    assert_shard_stable(want["stagewise"], ref)
    assert_shard_stable(want["chainwide"], ref)

    run_ranks(tmp_path, world, path, "gloo")
    check_ranks(tmp_path, world, want, want_moves)


def run_ranks(tmp_path, world: int, path: str, backend: str) -> None:
    """``world`` workers (this file as a script), each under a time limit,
    meeting through a FileStore under ``tmp_path``; each writes its
    outputs to ``tmp_path / out<rank>.npz``."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), store, str(r), str(world), path,
                               str(tmp_path / f"out{r}.npz"), backend],
                              env=env, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"a {backend} worker timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log_ in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log_[-3000:]}"


def check_ranks(tmp_path, world: int, want: dict, want_moves: tuple) -> None:
    """Every rank's gathered outputs equal ``want`` bit for bit, rank 0's
    carries too, and each rank holds its channels' demod state and its
    shards' moves."""
    per = 4 // world
    for r in range(world):
        with np.load(str(tmp_path / f"out{r}.npz")) as got:
            for k in ("stagewise", "chainwide", "bank"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"rank {r}: {k}")
            if r == 0:
                for k in ("stagewise_tail", "chainwide_tail"):
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            # 8 channels, 2 a shard: rank r owns rows [2*per*r, 2*per*(r+1))
            np.testing.assert_array_equal(got["bank_state"], want["bank_state"][2 * per * r : 2 * per * (r + 1)])
            for i, w in enumerate(want_moves):
                np.testing.assert_array_equal(got[f"move{i}"], w[per * r : per * (r + 1)] if i < 2 else w)


def worker(store: str, rank: int, world: int, path: str, out: str, backend: str) -> None:
    """One rank of a multi-process test: gloo on the CPU, or NCCL on card
    ``rank`` (``tests/test_torch_cuda.py``)."""
    import torch.distributed as dist

    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        mesh = make_mesh(4)
        per = 4 // world
        assert isinstance(mesh, DistMesh) and list(mesh.local_shards()) == list(range(per * rank, per * (rank + 1)))
        whole = ShardedFileIngest(path, mesh, TICK)
        seg = ShardedFileIngest(segment_path(path, rank), mesh, TICK, segment_of_host=True)
        assert whole.num_ticks == seg.num_ticks == N_TICKS
        res = run_all(mesh, list(whole.ticks()), list(seg.ticks()))
        res.update({f"move{i}": m for i, m in enumerate(mesh_moves(mesh))})
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
