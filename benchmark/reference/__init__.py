"""The benchmark's plain reference: NumPy and plain PyTorch that judge the
files a timed job wrote against inputs the benchmark made itself.  Nothing
here imports the program under test."""
