"""The §V fleet path, ported: platform model → voltage grid sweep →
predictors → scheduler → controller (see the package docstring)."""
