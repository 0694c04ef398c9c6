"""Time ``MarkovLM``'s successor draw at the vocabularies given:

    python -m repro_torch.data 50304 151936
"""
import sys
import time

from .pipeline import MarkovLM

for vocab in map(int, sys.argv[1:]):
    t0 = time.perf_counter()
    MarkovLM(vocab)
    print(f"MarkovLM({vocab}): {time.perf_counter() - t0:.1f} s", flush=True)
