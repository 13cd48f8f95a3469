"""Runtime of the port: checkpoint/restart, failure injection and
correlated failure models, straggler mitigation and elastic mesh
arithmetic."""
