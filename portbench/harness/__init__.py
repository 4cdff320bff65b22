"""The benchmark's yardstick: cells read from BENCHMARK.json, inputs made
from the seed, the measured window, the trace's reduction and the result
line."""
