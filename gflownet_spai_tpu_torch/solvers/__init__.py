"""Solvers and validation (this slice: ``validate.best_sampled_matrix``)."""
