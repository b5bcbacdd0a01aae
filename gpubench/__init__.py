"""The benchmark of physimglobalpose_tpu_torch (run.py); see PERF.md."""
