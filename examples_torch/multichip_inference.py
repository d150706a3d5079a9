"""Sites-sharded ML inference across processes.

The same ``infer_tree`` call as examples/multichip_inference.py, with a
``libpll_tpu_torch.parallel.mesh.SitesMesh`` of two ranks: each rank is a
process that makes the same call and holds half of the site patterns; the
stepwise build shards its Fitch word axis (one integer reduction an
insertion), the Partition keeps the rank's sites, and every sum over
sites (Newton's derivatives, each edge's logL, the SPR scores, the model
fit) meets the other rank's in one reduction.  Both ranks end with the
same tree and logL; rank 0 prints them.

Run on the CPU (two gloo ranks, a few seconds):
    python examples_torch/multichip_inference.py --device cpu
On one card (both ranks on cuda:0 through gloo):
    python examples_torch/multichip_inference.py
Where each rank has a card of its own, the ranks would pass
``backend="nccl"`` and ``device=f"cuda:{rank}"``.
"""

import argparse
import multiprocessing
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

WORLD = 2


def rank_main(init_method, rank, device):
    import torch

    from libpll_tpu_torch.parallel import mesh as pm
    from libpll_tpu_torch.search.infer import infer_tree
    from libpll_tpu_torch.tree import utree as ut

    torch.set_num_threads(1)
    pm.initialize_distributed(init_method, WORLD, rank, backend="gloo",
                              device=device, timeout=300)
    mesh = pm.make_sites_mesh(device=device)
    rng = np.random.default_rng(1)
    labels = [f"t{i}" for i in range(10)]
    seqs = {lab: "".join(rng.choice(list("ACGT"), 60)) for lab in labels}

    res = infer_tree(seqs, alpha=0.9, seed=42, radius=6, max_rounds=2,
                     mesh=mesh)
    if rank == 0:
        part = res.partition
        lo, hi = part.site_range
        print(f"mesh: {mesh.size} x {mesh.device.type}")
        print(f"parsimony start score: {res.start_parsimony_score}")
        print(f"final logL {res.logl:.4f} after {res.rounds} rounds")
        print(f"clv sharding: sites [{lo}, {hi}) of {part.global_sites} "
              f"on rank 0, {tuple(part.clv.shape)}; {mesh.reductions} "
              f"reductions, {mesh.reduce_seconds:.2f} s")
        print("tree:", ut.export_newick(res.tree.root)[:70], "...")
    torch.distributed.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help='"cpu", or the card when omitted')
    args = ap.parse_args()
    device = args.device or "cuda:0"
    # both ranks on this host: gloo over the loopback device (the spawned
    # ranks inherit the environment)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/rendezvous"
        procs = [ctx.Process(target=rank_main, args=(init, r, device))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        sys.exit(f"a rank failed: exit codes {codes}")


if __name__ == "__main__":
    main()
