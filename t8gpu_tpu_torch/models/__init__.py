"""Solvers and initial conditions."""
