"""One rank of the port's `examples/imagenet/ddp_analyze.py` on gloo.

    python torch_example_ddp_worker.py RENDEZVOUS WORLD RANK OUTDIR [script args...]

Joins a `file://` rendezvous, runs the script's `main(args)` (which finds the
group joined and keeps it), writes its scores to OUTDIR/scores_<rank>.pt and
leaves the group. One torch thread and one BLAS thread.
"""

import sys

import torch
from threadpoolctl import threadpool_limits


def main() -> None:
    rendezvous, world, rank, outdir, *argv = sys.argv[1:]
    torch.set_num_threads(1)
    from kronfluence_tpu_torch.examples.imagenet import ddp_analyze
    from kronfluence_tpu_torch.parallel import distributed

    distributed.initialize("gloo", init_method=f"file://{rendezvous}", world_size=int(world),
                           rank=int(rank))
    try:
        with threadpool_limits(limits=1):
            _, scores = ddp_analyze.main(argv)
        torch.save(scores, f"{outdir}/scores_{rank}.pt")
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
