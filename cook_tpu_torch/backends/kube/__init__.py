"""Kubernetes backend: only the checkpoint helpers the coordinator uses
(backends/kube/checkpoint.py) are ported; this package imports nothing,
so importing the checkpoint module does not pull in a kube controller."""
