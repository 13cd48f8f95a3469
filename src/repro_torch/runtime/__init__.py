"""Runtime helpers of the port: correlated failure models and elastic
mesh arithmetic (numpy and integers only)."""
