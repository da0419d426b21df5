"""Distributed mapping service (cloud/ analog); port of dliom_tpu/cloud/.

Counterpart of the reference's gRPC `MapBuilderServer` + `MapBuilderStub`
(cloud/internal/map_builder_server.{h,cc}, cloud/client/map_builder_stub.cc):
a robot-side frontend streams sensor data to a mapping server that owns the
MapBuilder; a dedicated SLAM thread drains a blocking queue in arrival order
(`ProcessSensorDataQueue`, map_builder_server.cc:142-153); queries read the
pose graph. Wire protocol is length-prefixed msgpack over TCP, the JAX
package's wire byte for byte, encoded and decoded by the port's own codec
(`wire.py`), so either package's client talks to the other's server.
"""

from dliom_tpu_torch.cloud.client import MapBuilderStub
from dliom_tpu_torch.cloud.server import MapBuilderServer
from dliom_tpu_torch.cloud.uploader import LocalTrajectoryUploader

__all__ = ["MapBuilderServer", "MapBuilderStub", "LocalTrajectoryUploader"]
