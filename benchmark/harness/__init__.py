"""The general machinery of the benchmark: names to files, the traffic
generator and its loops, the reduction of a profiler trace, the peaks of
the card, the comparison that decides ``correct`` and the import guard."""
