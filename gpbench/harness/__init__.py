"""The benchmark's own machinery: the cell's files found by name, the data
made from the seed, the measured window, the trace's reduction and the
comparison that decides ``correct``."""
