"""The end-to-end `request_p95_ms`, read by its own reader, reported per
layer in the cells whose closed-loop tail spreads too widely from run to
run for an end-to-end bound. There it moves the rate: a closed loop's
latency is its streams over its images a second."""
from pathlib import Path

from harness import load_module

read = load_module(Path(__file__).with_name('request_p95_ms.py'),
                   'metric_request_p95_ms').read
