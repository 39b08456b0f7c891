"""Prediction and the Eigen-protocol metrics."""
