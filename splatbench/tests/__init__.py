"""The benchmark's own tests, on the CPU at a tiny size (and, marked
``cuda``, on a card): ``python -m pytest splatbench/tests``."""
