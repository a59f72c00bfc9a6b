"""The benchmark's yardstick: cell lookup by name, timing, operation and
byte counts, weights made from the seed, the output comparison and the
result line.  Nothing here imports the program at module import time."""
