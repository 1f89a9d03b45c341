"""Complete workloads."""
