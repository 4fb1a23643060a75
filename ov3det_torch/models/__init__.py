"""Detector modules of the port."""
