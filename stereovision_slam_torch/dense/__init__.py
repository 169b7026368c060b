"""Offline dense 3-D reconstruction from a SLAM run's keyframes."""
