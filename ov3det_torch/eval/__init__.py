"""Prediction parsing of the port."""
