"""The port's sharded engine across two real processes.

The counterpart of ``tests/test_multihost.py`` and
``tests/multihost_child.py``: two ``torch.distributed`` processes (gloo,
a localhost rendezvous) each build a mesh of 4 CPU entries, so the pair
forms one 8-entry (4 × 2) mesh split 4/4.  Each builds the same
``ShardedServingEngine``, feeds only its ``local_streams``, and writes its
tiles; the parent reassembles them against the port's single engine and
the JAX package's ``ServingEngine`` fed the same packets.  The children
also run ``tick_many``, one ``microbatch=2`` flush, and the checkpoint
re-provision: the collective ``save_state`` (process 0 writes) -> a new
engine at 6 streams -> ``load_state(keep=[5, 0, 3])`` -> one live tick.

The child is this file run as a script:

    python tests/test_torch_multihost.py <rank> 2 <port> <outdir>
"""

import os
import socket
import subprocess
import sys

import numpy as np

SR, S, HOP, NS = 48000, 8, 800, 1_000_000_000
KEEP = [5, 0, 3]


def _cfg(pkg):
    return pkg.resolve(pkg.Settings(
        fft_size=256, width=128,
        temporal_smoothing=pkg.TSmoothingMode.NONE), pkg.AudioInfo(SR, 2))


def _packets(t: int) -> np.ndarray:
    pkt = np.zeros((S, 2, HOP), np.float32)
    for s in range(S):
        pkt[s] = 0.3 * np.random.default_rng(1000 * t + s).standard_normal(
            (2, HOP))
    return pkt


def _bulk() -> np.ndarray:
    return np.stack([np.stack([
        0.2 * np.random.default_rng(7000 + 10 * t + s).standard_normal(
            (2, HOP)).astype(np.float32) for s in range(S)])
        for t in range(2)])


def _save_tiles(outdir, prefix, rank, tiles) -> None:
    for k, t in enumerate(tiles):
        bounds = np.array([[sl.start or 0,
                            dim if sl.stop is None else sl.stop]
                           for sl, dim in zip(t.index, t.data.shape)],
                          np.int64)
        np.savez(os.path.join(outdir, f"{prefix}_{rank}_{k}.npz"),
                 data=t.data.numpy(), bounds=bounds)


def child(rank: int, nprocs: int, port: str, outdir: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import waveform_tpu_torch as wt
    from waveform_tpu_torch.parallel import ShardedServingEngine, make_mesh
    from waveform_tpu_torch.utils.checkpoint import to_host

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=nprocs, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    mesh = make_mesh(["cpu"] * 4, pixel_parallel=2)   # collective
    assert mesh.size == 4 * nprocs and len(mesh.local_entries()) == 4
    cfg = _cfg(wt)
    eng = ShardedServingEngine(cfg, S, mesh=mesh, use_native=False)
    lo, hi = eng.local_streams
    assert (hi - lo) == S // nprocs and lo == rank * (S // nprocs)

    now = NS
    for t in range(3):
        pkt = np.zeros((S, 2, HOP), np.float32)
        pkt[lo:hi] = _packets(t)[lo:hi]        # feed ONLY the local rows
        eng.feed_batch(pkt, now, now_ns=now)
        now += HOP * NS // SR
        eng.tick(now_ns=now)
    _save_tiles(outdir, "px", rank, eng.pixels_sharded)

    # bulk: each process uploads only its own rows
    last = [t._replace(data=t.data[-1], index=t.index[1:])
            for t in eng.tick_many(_bulk())]
    _save_tiles(outdir, "bulk", rank, last)

    # one microbatch=2 flush on a second engine
    mb = ShardedServingEngine(cfg, S, mesh=mesh, use_native=False,
                              microbatch=2)
    now_mb = NS
    for t in range(2):
        pkt = np.zeros((S, 2, HOP), np.float32)
        pkt[lo:hi] = _packets(t)[lo:hi]
        mb.feed_batch(pkt, now_mb, now_ns=now_mb)
        now_mb += HOP * NS // SR
        mb.tick(now_ns=now_mb)
    _save_tiles(outdir, "mb", rank, mb.last_batch_pixels)

    # checkpoint re-provision at a new stream count (the flow resized()
    # points multi-process groups at): collective save, process 0 writes
    db_old = to_host(eng.state.decibels)
    ck = os.path.join(outdir, "resize_ck.npz")
    eng.save_state(ck)
    eng2 = ShardedServingEngine(cfg, 6, mesh=mesh, use_native=False)
    eng2.load_state(ck, keep=KEEP)           # collective (gathers rows)
    db_new = to_host(eng2.state.decibels)
    if rank == 0:
        np.savez(os.path.join(outdir, "resize.npz"), db_old=db_old,
                 db_new=db_new, keep=np.asarray(KEEP))
    for s in range(*eng2.local_streams):      # one live tick
        r = np.random.default_rng(9000 + s)
        eng2.feed(s, 0.3 * r.standard_normal((2, HOP)).astype(np.float32),
                  now, now_ns=now)
    eng2.tick(now_ns=now + HOP * NS // SR)
    assert all(torch.isfinite(t.data).all() for t in eng2.pixels_sharded)
    dist.barrier()
    dist.destroy_process_group()
    print(f"child {rank}: local rows [{lo}, {hi}) ok")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _assemble(tmp_path, prefix, shape):
    files = sorted(tmp_path.glob(f"{prefix}_*.npz"))
    assert len(files) == 8    # 8 mesh entries, one tile each
    got = np.full(shape, np.nan, np.float32)
    for f in files:
        z = np.load(f)
        got[tuple(slice(a, b) for a, b in z["bounds"])] = z["data"]
    assert np.isfinite(got).all()   # every tile written
    return got


def test_two_process_sharded_engine_matches_single(tmp_path):
    # JAX only in the parent: the children run the port alone
    import waveform_tpu as jwt
    from waveform_tpu.runtime.serving import ServingEngine as JaxEngine
    from waveform_tpu.utils.checkpoint import load_pytree as jax_load

    import waveform_tpu_torch as wt
    from waveform_tpu_torch.runtime.serving import ServingEngine

    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(i), "2", str(port),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"child failed:\n{out[-3000:]}"

    single = ServingEngine(_cfg(wt), S, use_native=False, device="cpu")
    ref = JaxEngine(_cfg(jwt), S, use_native=False)
    now = NS
    for t in range(3):
        for eng in (single, ref):
            eng.feed_batch(_packets(t), now, now_ns=now)
        now += HOP * NS // SR
        for eng in (single, ref):
            eng.tick(now_ns=now)
    shape = single.read_pixels().shape
    got = _assemble(tmp_path, "px", shape)
    np.testing.assert_allclose(got, single.read_pixels(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(ref.read_pixels()), rtol=0,
                               atol=1e-4)

    want_bulk = single.tick_many(_bulk())[-1].numpy()
    np.testing.assert_allclose(_assemble(tmp_path, "bulk", shape), want_bulk,
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(want_bulk, np.asarray(ref.tick_many(
        _bulk())[-1]), rtol=0, atol=1e-4)

    mb = ServingEngine(_cfg(wt), S, use_native=False, device="cpu")
    now = NS
    flush = []
    for t in range(2):
        mb.feed_batch(_packets(t), now, now_ns=now)
        now += HOP * NS // SR
        flush.append(mb.tick(now_ns=now).numpy())
    np.testing.assert_allclose(_assemble(tmp_path, "mb", (2,) + shape),
                               np.stack(flush), rtol=0, atol=1e-4)

    # re-provision: kept rows carry their dB verbatim, the rest are fresh
    z = np.load(tmp_path / "resize.npz")
    db_old, db_new = z["db_old"], z["db_new"]
    for i, j in enumerate(KEEP):
        np.testing.assert_array_equal(db_new[i], db_old[j])
    assert (db_new[len(KEEP):6] == np.float32(wt.DB_MIN)).all()
    # the collective save is a ServingEngine checkpoint of either package
    ck = str(tmp_path / "resize_ck.npz")
    back = ServingEngine(_cfg(wt), S, use_native=False, device="cpu")
    back.load_state(ck)
    np.testing.assert_array_equal(back.state.decibels.numpy(), db_old)
    jstate, _, _ = jax_load(ck, (ref.state, ref.ring, ref.rms_ring))
    np.testing.assert_array_equal(np.asarray(jstate.decibels), db_old)


if __name__ == "__main__":
    child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
