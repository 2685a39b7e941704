"""Time the batched-inference main path of one checkout of the port.

    python tpuseg_torch/tools/ab_infer.py <tree root> [n_images] [repeats] \
        [n_devices] [processes]

Imports ``tpuseg_torch`` from ``<tree root>`` (which also holds
``assets/synthetic_ckpt.msgpack``), builds its ``ir_chain`` kernel, and
runs ``Predictor.predict_batch_packed`` at B=32 in bfloat16 over synthetic
hard scenes: one warm-up batch, then ``repeats`` timed passes; prints the
img/s of each pass.  ``n_devices`` > 1 times the mesh predictor
(``use_mesh=True``: that many replicas, replica i on card i % cards); with
``processes`` it times that many rank processes instead, as ``pred_list
--ndevices`` runs them (``parallel/tasks.py::timed_inference``: each rank
on its whole batches, every pass started at a barrier; img/s = the images
over the slowest rank's pass).  To compare two commits on one card, unpack the other
one with ``git archive`` into a directory ``.gitignore`` lists and run
parent, change, change, parent within one call: host-side time varies
between machines by more than most changes do.
"""

import os
import sys
import time


def main(argv) -> int:
    root = os.path.abspath(argv[1])
    n_images = int(argv[2]) if len(argv) > 2 else 128
    repeats = int(argv[3]) if len(argv) > 3 else 3
    n_devices = int(argv[4]) if len(argv) > 4 else 1
    processes = len(argv) > 5 and argv[5] == "processes"
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import tpuseg_torch

    if not os.path.abspath(tpuseg_torch.__file__).startswith(root):
        raise RuntimeError(
            f"tpuseg_torch came from {tpuseg_torch.__file__}, not {root}")
    from tpuseg_torch.cli.common import load_model
    from tpuseg_torch.data.synthetic import make_scene
    from tpuseg_torch.kernels import build
    from tpuseg_torch.runtime.predict import Predictor
    from tpuseg_torch.settings import get_config
    from tpuseg_torch.utils.checkpoint_io import load_stop_params

    build.build(["ir_chain"])
    cfg, model = load_model(
        get_config("CVPPP"),
        os.path.join(root, "assets", "synthetic_ckpt.msgpack"))
    rng = np.random.default_rng(7)
    imgs = np.stack([make_scene(rng, 256, 256, hard=True)[0]
                     for _ in range(n_images)])
    if processes:
        from tpuseg_torch.parallel import run_ranks, tasks

        sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        ranks = run_ranks(tasks.timed_inference, n_devices, args=(
            cfg, sd, imgs, 32, repeats, load_stop_params()), timeout=1800)
        rates = [n_images / max(r["seconds"][i] for r in ranks)
                 for i in range(repeats)]
        print(argv[1], f"{n_devices} rank processes on "
              f"{torch.cuda.device_count()} card(s), images a rank "
              f"{[r['images'] for r in ranks]}: img/s",
              [round(r, 2) for r in rates], flush=True)
        return 0
    mesh = dict(use_mesh=True, n_devices=n_devices) if n_devices > 1 else {}
    pred = Predictor(cfg, model, batch_size=32, device="cuda",
                     stop_params=load_stop_params(), **mesh)
    batches = [imgs[i:i + 32] for i in range(0, n_images, 32)]
    pred.predict_batch_packed(batches[0])
    torch.cuda.synchronize()
    rates = []
    for _ in range(repeats):
        t = time.perf_counter()
        for b in batches:
            packed, counts = pred.predict_batch_packed(b)
            packed.cpu(), counts.cpu()
        torch.cuda.synchronize()
        rates.append(n_images / (time.perf_counter() - t))
    print(argv[1], f"replicas {len(pred.replicas)} on "
          f"{torch.cuda.device_count()} card(s): img/s",
          [round(r, 2) for r in rates], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
