"""General code of the benchmark: nothing here names a cell."""
