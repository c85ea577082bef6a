"""The benchmark's own library: the manifest and a cell's files, the input
maker, seeded weights, the frozen work counts and peaks, the measured
window and the reduction of a profiler trace. Nothing here imports the
program; the drivers in ``benchmark/drivers`` do."""
