"""Cells cut to a size the CPU runs in seconds, for the tests: the cell's
own configuration, mix, entry and limits, at a 64x64 canvas, B=2, a
pool of 4 scenes (a seeded pool of 2), the program in float32 where
asked."""

import copy

from segbench import cells


def small_cell(name: str, hw: int = 64, batch: int = 2, dtype: str = "",
               distinct: int = 0):
    c = copy.deepcopy(cells.load_cell(name))
    c["mix"]["scene"].update(height=hw, width=hw)
    c["mix"].pop("canvas", None)
    c["mix"]["pool"] = 4
    if "seeded_pool" in c["mix"]:
        c["mix"]["seeded_pool"] = 2
    c["configuration"]["canvas"] = [hw, hw]
    if dtype:
        c["configuration"]["dtype"] = dtype
    p = c["params"]
    p["batch"] = batch
    p["distinct_batches"] = distinct or (p.get("check_steps", 0) + 1
                                         if c["entry"] == "train" else 2)
    if "check_batches" in p:
        p["check_batches"] = 1
    return c
