"""The harness of the port's benchmark: cells, traffic, weights, traffic runners,
traces and the comparison that decides `correct`."""
