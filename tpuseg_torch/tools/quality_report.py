"""Round evidence: the port's full CLI chain on the frozen eval asset with
the committed checkpoint, as a markdown quality report (port of
``tools/quality_report.py``).

    python -m tpuseg_torch.tools.quality_report [--n_images 64] [--easy]
        [--fresh_seed S] [--report PATH] [--device cpu]

By default the 64 images of the frozen, sha256-pinned
``assets/eval_hard64``; ``--fresh_seed``, ``--easy`` or another
``--n_images`` generate a fresh tree instead.  ``pred_list`` (bf16, batch
16 as in the JAX tool, or the image count where that is smaller) runs
twice, each a new process that loads CUDA, cuDNN and the weights: run 1
is the cold start (the kernels built at first use unless
``tpuseg_torch/kernels/_build`` holds them already), run 2 finds them
built; then ``evaluate``.  In place of the JAX package's TPU bench,
``tpuseg_torch/tools/ab_infer.py`` times the main path on this checkout
(B=32 bf16 over 128 synthetic scenes, 3 passes) on the card; with
``--device cpu`` the report says it did not run.  The report goes to ``--report`` (default ``tpuseg_torch_report/REPORT.md``
under the temporary directory) and keeps that file's NATIVE_RES and
SEED_VARIANCE sections.  The repo's ``REPORT.md`` is written only when
given as ``--report``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

from tpuseg_torch import resolve_device
from tpuseg_torch.tools.native_res_report import (
    A1, CKPT, REPO, REPORT, cli, parse_launches, parse_metrics, sh,
)

AB_IMAGES = 128
KEPT_SECTIONS = [("<!-- NATIVE_RES:BEGIN -->", "<!-- NATIVE_RES:END -->"),
                 ("<!-- SEED_VARIANCE:BEGIN -->",
                  "<!-- SEED_VARIANCE:END -->")]


def keep_sections(report: str, old: str) -> str:
    """``report`` followed by each marked section ``old`` holds."""
    for begin, end in KEPT_SECTIONS:
        if begin in old and end in old:
            report = report.rstrip() + "\n\n" + old[
                old.index(begin): old.index(end) + len(end)] + "\n"
    return report


def smi_line() -> str:
    return sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).strip().splitlines()[0]


def run(n_images: int = 64, hard: bool = True, fresh_seed: int = 0,
        report: str = REPORT, device: str = "cuda") -> Dict:
    """Write the report; returns ``{"sbd", "dic", "fg", "cold_s",
    "warm_s", "ab_infer", "card", "pred_dir", "lst", "report",
    "ir_chain_launches", "rounds"}`` (both ``pred_list`` runs')."""
    dev = resolve_device(device)
    # padding a batch past the images does no work for any of them
    batch = min(16, n_images)
    tmp = tempfile.mkdtemp(prefix="tpuseg_torch_report_")
    if fresh_seed or not hard or n_images != 64:
        # escape hatch: the live generator (seed sweeps, easy preset, other
        # sizes), not the pinned headline path
        from tpuseg_torch.data.synthetic import write_synthetic_eval_tree

        lst = write_synthetic_eval_tree(tmp, n_images, seed=fresh_seed or 99,
                                        hard=hard, max_leaves=14)
        eval_src = f"freshly generated (seed {fresh_seed or 99})"
    else:
        from tpuseg_torch.data.eval_asset import (
            default_asset_prefix, materialize_eval_tree,
        )

        prefix = default_asset_prefix()
        lst = materialize_eval_tree(prefix, tmp)
        with open(prefix + ".sha256") as f:
            eval_src = ("frozen assets/eval_hard64 (sha256 "
                        + f.read().split()[0][:12] + "…)")
    out_dir = os.path.join(tmp, "outputs")

    pred_cmd = cli("pred_list", "--lst", lst, "--model", CKPT, "--dataset",
                   "CVPPP", "--batchsize", str(batch), "--output", out_dir,
                   "--device", device)
    t0 = time.time()
    cold = sh(pred_cmd, tail=2000)
    cold_s = time.time() - t0
    t0 = time.time()
    warm = sh(pred_cmd, tail=2000)
    warm_s = time.time() - t0
    ev = sh(cli("evaluate", "--pred_dir", out_dir, "--dataset", "CVPPP",
                "--metadata", os.path.dirname(lst), "--img_dir",
                os.path.join(tmp, *A1), "--device", device), tail=2000)
    sbd, dic, fg = parse_metrics(ev)
    launches = [parse_launches(cold), parse_launches(warm)]
    if dev.type == "cuda":
        card = smi_line()
        ab = sh([sys.executable,
                 os.path.join(REPO, "tpuseg_torch", "tools", "ab_infer.py"),
                 REPO, str(AB_IMAGES), "3"]).strip().splitlines()[-1]
        timing = (f"{ab}\ncard: {card}\n"
                  f"(ab_infer's timing of this checkout, B=32 bf16 over "
                  f"{AB_IMAGES} synthetic hard 256² scenes, 3 passes after "
                  "a warm-up batch; not a benchmark cell)")
    else:
        card, ab = None, None
        timing = "not run: ab_infer times the card"

    text = f"""# tpuseg_torch report

Generated by tpuseg_torch/tools/quality_report.py on {n_images} synthetic
CVPPP-style images ({'hard preset: off-center plants, wavy occluding leaves, wide scale variance' if hard else 'default preset'});
eval data: {eval_src}
with the committed `assets/synthetic_ckpt.msgpack` weights, bf16, batch
{batch}, on `{device}` (metrics demonstrate the pipeline, not CVPPP state of the art).

## evaluate output
```
{ev.strip()}
```

## ab_infer timing
```
{timing}
```

## pred_list wall time
{n_images} images end-to-end, run 1 (cold start: a new process, the
kernels built at first use unless already built): {cold_s:.1f}s
{n_images} images end-to-end, run 2 (a new process, the kernels already
built): {warm_s:.1f}s
"""
    old = open(report).read() if os.path.isfile(report) else ""
    text = keep_sections(text, old)
    os.makedirs(os.path.dirname(os.path.abspath(report)), exist_ok=True)
    with open(report, "w") as f:
        f.write(text)
    print(text, flush=True)
    return {"sbd": sbd, "dic": dic, "fg": fg, "cold_s": cold_s,
            "warm_s": warm_s, "ab_infer": ab, "card": card,
            "pred_dir": out_dir, "lst": lst, "report": report,
            "ir_chain_launches": [launches[0][0], launches[1][0]],
            "rounds": [launches[0][1], launches[1][1]]}


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n_images", type=int, default=64)
    p.add_argument("--easy", action="store_true")
    p.add_argument("--fresh_seed", type=int, default=0,
                   help="regenerate eval data from the live generator at "
                        "this seed instead of the frozen asset")
    p.add_argument("--report", default=REPORT)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    return run(a.n_images, hard=not a.easy, fresh_seed=a.fresh_seed,
               report=a.report, device=a.device)


if __name__ == "__main__":
    main()
