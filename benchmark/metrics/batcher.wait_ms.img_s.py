"""`batcher.wait_ms`, read by its own reader, in the cells whose tail is
reported per layer (`request_p95_ms.img_s`), where it moves the rate."""
from pathlib import Path

from harness import load_module

read = load_module(Path(__file__).with_name('batcher.wait_ms.py'),
                   'metric_batcher_wait_ms').read
