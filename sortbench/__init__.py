"""The benchmark of vkradixsort_tpu_torch on the H100 (``run.py``)."""
