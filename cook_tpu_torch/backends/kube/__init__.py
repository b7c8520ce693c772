"""Kubernetes-style compute backend.

Equivalent of the reference's kubernetes/ layer:
  api.py        typed pod/node model + KubeApi client protocol + an
                in-memory FakeKube with watches and a toy autoscaler
                (kubernetes/api.clj + testutil fake cluster)
  controller.py the (cook-expected-state x k8s-actual-state) state
                machine with sharded pod locks (kubernetes/controller.clj)
  cluster.py    ComputeCluster impl: node/pod watches -> offers,
                launches via expected-state writes, synthetic-pod
                autoscaling, startup reconstruction
                (kubernetes/compute_cluster.clj)
  http_api.py   the real-apiserver KubeApi: list/watch streams with
                resourceVersion resume + reconnect, pod CRUD, bearer
                auth (kubernetes/api.clj:200,281,333,1088 +
                WatchHelper.java)
  standin.py    HTTP-level apiserver stand-in serving a FakeKube over
                the genuine wire protocol (watch JSON, 410 Gone) for
                tests/dev
"""
from cook_tpu_torch.backends.kube.api import FakeKube, KubeApi, Node, Pod, PodPhase
from cook_tpu_torch.backends.kube.cluster import KubeCluster
from cook_tpu_torch.backends.kube.controller import (ExpectedState, KubeController,
                                               PodState)
from cook_tpu_torch.backends.kube.http_api import HttpKube

__all__ = ["FakeKube", "HttpKube", "KubeApi", "Node", "Pod", "PodPhase",
           "KubeCluster", "KubeController", "ExpectedState", "PodState"]
