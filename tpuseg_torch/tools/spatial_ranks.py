"""Spatial (H-sharded) inference over N rank processes against one process.

    python tpuseg_torch/tools/spatial_ranks.py [n_ranks] [side] [repeats]

Full-width CVPPP model, ``assets/synthetic_ckpt.msgpack``, two synthetic
hard scenes at ``side`` x ``side``: ``parallel/tasks.py::spatial_infer``
on ``n_ranks`` ranks (NCCL when each rank has a card of its own, else
gloo) and in this process.  Prints whether the float32 id maps and counts
agree, each rank's ``ir_chain`` launches, and the bfloat16 ms a batch of
the ranks beside one process's (``repeats`` timed passes after one).
"""

import os
import sys


def main(argv) -> int:
    n_ranks = int(argv[1]) if len(argv) > 1 else 2
    side = int(argv[2]) if len(argv) > 2 else 512
    repeats = int(argv[3]) if len(argv) > 3 else 3
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from tpuseg_torch.cli.common import load_model
    from tpuseg_torch.data.synthetic import make_scene
    from tpuseg_torch.kernels import build
    from tpuseg_torch.parallel import make_mesh, run_ranks, tasks
    from tpuseg_torch.settings import get_config
    from tpuseg_torch.utils.checkpoint_io import load_stop_params

    build.build()
    cfg, model = load_model(get_config("CVPPP"), os.path.join(
        root, "assets", "synthetic_ckpt.msgpack"))
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(41)
    imgs = np.stack([make_scene(rng, side, side, hard=True)[0]
                     for _ in range(2)])
    stop = load_stop_params()
    calls = [(tasks.spatial_infer, (cfg, sd, [imgs], None, stop,
                                    torch.float32)),
             (tasks.spatial_infer, (cfg, sd, [imgs], None, stop,
                                    torch.bfloat16, False, repeats))]
    ranks = run_ranks(tasks.in_turn, n_ranks, args=(calls,), timeout=1800)
    one = [task(make_mesh(1, "cuda"), *args) for task, args in calls]
    idmap = torch.cat([r[0]["outs"][0]["idmap"] for r in ranks], dim=1)
    want = one[0]["outs"][0]
    print(f"spatial inference, {n_ranks} ranks on "
          f"{torch.cuda.device_count()} card(s), {side}x{side} B=2: id maps "
          f"agree on {float((idmap == want['idmap']).float().mean()):.6f}, "
          f"counts {[r[0]['outs'][0]['counts'].tolist() for r in ranks]} vs "
          f"{want['counts'].tolist()}; ir_chain launches a rank "
          f"{[r[0]['launches']['ir_chain'] for r in ranks]} (one process "
          f"{one[0]['launches']['ir_chain']}); bf16 ms a batch "
          f"{[round(r[1]['ms_per_batch'], 2) for r in ranks]} vs one process "
          f"{one[1]['ms_per_batch']:.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
