"""Homography helpers."""
