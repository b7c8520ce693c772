"""Compute backends: ComputeCluster protocol, mock, k8s-style."""
