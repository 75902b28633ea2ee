"""Tiny traffic for CPU runs of the cells: the same code paths at sizes
a CPU test holds."""

POSE = {"batch": 8, "n_shapes": 2, "poses_per_shape": 2, "max_pc": 400,
        "v_cad": 640, "v_pc": 512, "nu": 16, "nv": 32, "n_hypotheses": 1024,
        "warmup_batches": 1, "judge_batches": 1, "trace_batches": 1,
        "ref_chunk": 4, "workers": 2}
TINY = {"orig.pose_b64": POSE}
