"""Worker process of tests/test_torch_distributed.py.

Spawned twice (one per process, 4 mesh slots on the CPU each: 2 dp rows x
2 tp slots, so the mesh is dp 4 x tp 2 and every tp pair is local); joins
the processes over gloo, then runs:

1. the identical-inputs sharded forward (`ShardedForward.gather`),
2. the per-process stream (`distributed.local_batch`) and `fetch_local`,
   then `barrier` and `log_once` (one line over both processes),
3. the Engine, the VectorIndex (save/load) and the SparseIndex on the
   multi-process mesh, under the leader-follower serving plane.

Outputs land in <outdir> as .npy / .npz files for the parent test.
"""
import sys


def main() -> None:
    pid, nprocs, port, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]

    import dataclasses

    import numpy as np
    import torch

    from embedding_cpp_tpu_torch.models import BertConfig, ComputeOptions, random_params
    from embedding_cpp_tpu_torch.parallel import distributed as dist
    from embedding_cpp_tpu_torch.parallel.mesh import make_mesh
    from embedding_cpp_tpu_torch.parallel.sharding import shard_params_and_make_forward
    from embedding_cpp_tpu_torch.runtime.engine import Engine
    from embedding_cpp_tpu_torch.runtime.search import VectorIndex

    torch.set_num_threads(1)
    backend = dist.initialize(f"127.0.0.1:{port}", nprocs, pid, devices=["cpu"])
    assert backend == "gloo", backend
    cfg = BertConfig(n_vocab=256, n_ctx=64, n_embd=128, n_layer=2, n_head=4, n_ff=256,
                     name="dist-test")
    opts = ComputeOptions(dtype="float32")
    mesh = make_mesh(tp=2, devices=["cpu"] * 4)
    assert mesh.shape == {"dp": 4, "tp": 2}, mesh.shape

    # --- raw forward paths ---------------------------------------------------
    params = random_params(cfg, "q4_0", seed=0)
    sharded, fwd = shard_params_and_make_forward(params, cfg, opts, mesh)
    rng = np.random.default_rng(0)
    batch = 2 * mesh.dp
    ids = rng.integers(0, cfg.n_vocab, size=(batch, 16)).astype(np.int32)
    mask = np.ones((batch, 16), np.int32)
    mask[:, 12:] = 0
    gidx = np.arange(batch, dtype=np.int32)
    with torch.inference_mode():
        out_bcast = fwd.gather(sharded, dist.global_batch(mesh, ids),
                               dist.global_batch(mesh, mask), gidx).numpy()
        rows = batch // nprocs
        lo = pid * rows
        out_stream = fwd.gather(sharded, dist.local_batch(mesh, ids[lo:lo + rows]),
                                dist.local_batch(mesh, mask[lo:lo + rows]), gidx).numpy()
        local_rows = dist.fetch_local(fwd(sharded, ids, mask))
    np.save(f"{outdir}/local_rows_{pid}.npy", local_rows)
    if pid == 0:
        np.save(f"{outdir}/out_bcast.npy", out_bcast)
        np.save(f"{outdir}/out_stream.npy", out_stream)
    dist.barrier()
    dist.log_once("workers: every raw forward written")

    # --- Engine and indexes under the leader-follower plane ------------------
    engine = Engine.synthetic(dataclasses.replace(cfg, mlm_head=True), "q4_0", opts=opts,
                              mesh=mesh)
    vecs = np.random.default_rng(7).standard_normal((37, engine.n_embd)).astype(np.float32)
    queries = vecs[:5].copy()
    sidx = VectorIndex(engine, mesh=mesh)
    sidx.add_vectors(vecs)
    i1, s1 = sidx.search_vectors(queries, k=3)
    path = f"{outdir}/dist_index_{pid}.npz"
    sidx.save(path)
    sidx2 = VectorIndex(engine, mesh=mesh)
    assert sidx2.load(path) == 37
    i2, s2 = sidx2.search_vectors(queries, k=3)
    if pid == 0:
        np.savez(f"{outdir}/index_roundtrip.npz", i1=i1, s1=s1, i2=i2, s2=s2)

    token_lists = [[2] + row.tolist() + [3]
                   for row in np.random.default_rng(1).integers(4, cfg.n_vocab, size=(12, 9))]
    if pid == 0:
        dist.make_leader(engine)
        np.save(f"{outdir}/engine_out.npy", engine.embed_tokens(token_lists))
        lidx = dist.make_leader_index(engine)
        lidx.add_vectors(vecs)
        lidx.save(f"{outdir}/leader_index.npz")
        li, ls = lidx.search_vectors(queries, k=3)
        np.savez(f"{outdir}/leader_index_results.npz", li=li, ls=ls)
        sp = dist.make_leader_sparse_index(engine)
        pairs = engine.sparse_tokens(token_lists, k=16)
        sp.add_vectors(pairs)
        si, ss = sp.search_vectors(pairs[:3], k=4)
        np.savez(f"{outdir}/sparse_leader_results.npz", si=si, ss=ss,
                 **{f"pair_i{j}": p[0] for j, p in enumerate(pairs)},
                 **{f"pair_v{j}": p[1] for j, p in enumerate(pairs)})
        dist.broadcast_stop()
    else:
        dist.follower_loop(engine)
    dist.shutdown()
    print(f"worker {pid}: done", flush=True)


if __name__ == "__main__":
    main()
