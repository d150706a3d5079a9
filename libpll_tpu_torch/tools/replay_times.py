"""Time the replay kernels U1 and C1 of several checkouts, or of source
variants of ``csrc/partials.cu``, in turns on one card.

    python3 libpll_tpu_torch/tools/replay_times.py [TREE ...]
    python3 libpll_tpu_torch/tools/replay_times.py --variants SPEC.json NAME ...

Each run is its own process, in the order given (parent, change, change,
parent compares two commits on one card).  A TREE is a checkout's root
(default: this one); it is measured with its own package and its own
``chip_smoke.py`` helpers.  A variant is this checkout's ``partials.cu``
with the text substitutions ``SPEC.json`` names for it
(``tools/variants.py``; ``tools/replay_ablations.json``), built by nvcc
beside the package's build and called in place of its library.

Measured: U1 (``replay_ops_f64``) on a full ``update_partials`` of the
float64 flagship Partition (chip_smoke's ``flagship_blopt_partition``:
64 taxa, 262 144 patterns, GTR+Γ4, 62 ops) and, where the tree has it, C1
(``score_candidates_f32``) on the first batch of chip_smoke phase 31's
SPR neighbourhood (``spr_partition``: scripts/bench_spr.py's 1 024 taxa x
16 384 sites, 32 candidates); device ms a call over back-to-back calls
(``chip_smoke.time_ms``) and a SHA-256 of each kernel's output, to compare
bits between runs.  Each run prints one JSON line; the card's name and
power limit come first.
"""

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(Path(__file__).resolve().parent))

from variants import build_variants, card_line  # noqa: E402


def _digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def measure(tree, lib_path=None):
    """One run in this process: the numbers of the module docstring."""
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from libpll_tpu_torch.engine.partition import operations_to_array
    from libpll_tpu_torch.ops import clv as clv_ops
    from libpll_tpu_torch.tree import utree as ut

    device = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = ctypes.CDLL(str(lib_path)) if lib_path else \
        clv_ops.load_kernels()
    u1 = lib.replay_ops_f64
    u1.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_int64] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    u1.restype = ctypes.c_int
    out = {"tree": str(tree), "variant": lib_path and Path(lib_path).parent.name}

    part, _, tree_, pidx, _, _ = cs.flagship_blopt_partition(device)
    ops, branches, pmat_idx = ut.create_operations(ut.traverse(tree_.root))
    part.update_prob_matrices(pidx, pmat_idx, branches)
    table = torch.from_numpy(operations_to_array(
        ops, part.scale_buffers)).to(device)
    _, c, s, length = part.clv.shape

    def run_u1():
        cs.check(u1(part.clv.data_ptr(), part.scalers.data_ptr(),
                    part.pmatrix.data_ptr(), table.data_ptr(),
                    table.shape[0], c, s, length, part.scale_mode,
                    part.scale_buffers, stream) == 0, "U1 launch failed")

    run_u1()
    out["u1_sha256"] = _digest(part.clv, part.scalers)
    out["u1_ms"] = cs.time_ms(run_u1, iters=10, warmup=2)[0]
    del part
    torch.cuda.empty_cache()

    if hasattr(lib, "score_candidates_f32") and hasattr(cs, "spr_partition"):
        from libpll_tpu_torch.engine.evaluate import partition_model
        from libpll_tpu_torch.ops import incremental as inc_ops
        from libpll_tpu_torch.search import spr

        c1 = lib.score_candidates_f32
        c1.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                       + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
        c1.restype = ctypes.c_int
        sp, stree = cs.spr_partition(device)
        cs.full_state(stree, sp, [0] * 4)
        prune = ut.query_innernodes(stree)[:cs.SPR_PRUNE]
        enc, _ = spr.encode_candidates(stree, spr.spr_neighborhood(
            stree, cs.SPR_RADIUS, prune_nodes=prune))
        _, t, mi, bl, er = next(spr.encoded_batches(
            enc, sp.nodes, sp.scale_buffers, cs.SPR_CAP, cs.SPR_BATCH))
        rows = inc_ops.check_tables(
            t, mi, er, n_nodes=sp.nodes, n_scale_buffers=sp.scale_buffers,
            n_matrices=sp.pmatrix.shape[0], capacity=cs.SPR_CAP,
            scale_mode=sp.scale_mode)
        model = partition_model(sp, [0] * 4)
        tab, midx = (torch.from_numpy(a).to(device) for a in (t, mi))
        new = inc_ops.compute_pmatrices(
            torch.from_numpy(bl).to(device, torch.float32).reshape(-1),
            model["rates"], model["prop_invar"], model["params_indices"],
            model["eigenvals"], model["left"], model["right"],
            dtype=torch.float32).reshape(
                (cs.SPR_BATCH, mi.shape[1]) + tuple(sp.pmatrix.shape[1:])
            ).contiguous()
        scratch, scal = inc_ops._scratch(sp.clv, sp.scalers, cs.SPR_BATCH,
                                         rows, sp.scale_mode)
        _, c, s, length = sp.clv.shape

        def run_c1():
            cs.check(c1(sp.clv.data_ptr(), sp.scalers.data_ptr(),
                        sp.pmatrix.data_ptr(), tab.data_ptr(), tab.shape[1],
                        midx.data_ptr(), new.data_ptr(), mi.shape[1],
                        scratch.data_ptr(), scal.data_ptr(), rows,
                        cs.SPR_BATCH, sp.nodes, sp.scale_buffers, c, s,
                        length, sp.scale_mode, stream) == 0,
                     "C1 launch failed")

        scratch.zero_()
        scal.zero_()
        run_c1()
        out["c1_sha256"] = _digest(scratch, scal)
        out["c1_ms"] = cs.time_ms(run_c1, iters=20, warmup=3)[0]
    print(json.dumps(out), flush=True)


def main(argv):
    if argv[:1] == ["--measure"]:
        measure(Path(argv[1]), argv[2] if len(argv) > 2 else None)
        return 0
    print(f"card: {card_line()}", flush=True)
    if argv[:1] == ["--variants"]:
        spec = json.loads(Path(argv[1]).read_text())
        libs = build_variants(spec, argv[2:], "partials")
        runs = [(str(ROOT), str(libs[name])) for name in argv[2:]]
    else:
        runs = [(str(Path(tree).resolve()),) for tree in argv or [ROOT]]
    for run in runs:
        subprocess.run([sys.executable, __file__, "--measure", *run],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
