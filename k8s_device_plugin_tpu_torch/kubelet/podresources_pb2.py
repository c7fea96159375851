"""Hand-authored message classes for the kubelet PodResources API (v1).

Same protoc-free constraint as the device-plugin contract (see api.py):
grpcio is installed without grpcio-tools, so there is no protoc to run.
``deviceplugin_pb2.py`` vendors a protoc-generated serialized descriptor;
for this second proto we go one step further and build the
``FileDescriptorProto`` programmatically at import time — every field
number and type below is the wire contract and must match
``k8s.io/kubelet/pkg/apis/podresources/v1/api.proto`` exactly
(podresources.proto in this directory carries the readable definition).

The DRA messages (``DynamicResource`` et al., ``ContainerResources``
field 5) are intentionally not declared: proto3 parsers skip unknown
fields, so a real kubelet that streams them still interoperates, and the
plugin only attributes device-plugin-managed resources.
"""

from __future__ import annotations

from google.protobuf import descriptor_pb2 as _dpb
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf.internal import builder as _builder

_F = _dpb.FieldDescriptorProto

_fdp = _dpb.FileDescriptorProto(
    name="podresources.proto", package="v1", syntax="proto3"
)


def _field(name, number, type_, label=_F.LABEL_OPTIONAL, type_name=None):
    f = _F(name=name, number=number, type=type_, label=label)
    if type_name is not None:
        f.type_name = type_name
    return f


def _message(name, *fields):
    m = _fdp.message_type.add(name=name)
    m.field.extend(fields)


_message("AllocatableResourcesRequest")
_message(
    "AllocatableResourcesResponse",
    _field("devices", 1, _F.TYPE_MESSAGE, _F.LABEL_REPEATED, ".v1.ContainerDevices"),
    _field("cpu_ids", 2, _F.TYPE_INT64, _F.LABEL_REPEATED),
    _field("memory", 3, _F.TYPE_MESSAGE, _F.LABEL_REPEATED, ".v1.ContainerMemory"),
)
_message("ListPodResourcesRequest")
_message(
    "ListPodResourcesResponse",
    _field("pod_resources", 1, _F.TYPE_MESSAGE, _F.LABEL_REPEATED, ".v1.PodResources"),
)
_message(
    "PodResources",
    _field("name", 1, _F.TYPE_STRING),
    _field("namespace", 2, _F.TYPE_STRING),
    _field("containers", 3, _F.TYPE_MESSAGE, _F.LABEL_REPEATED, ".v1.ContainerResources"),
)
_message(
    "ContainerResources",
    _field("name", 1, _F.TYPE_STRING),
    _field("devices", 2, _F.TYPE_MESSAGE, _F.LABEL_REPEATED, ".v1.ContainerDevices"),
    _field("cpu_ids", 3, _F.TYPE_INT64, _F.LABEL_REPEATED),
    _field("memory", 4, _F.TYPE_MESSAGE, _F.LABEL_REPEATED, ".v1.ContainerMemory"),
)
_message(
    "ContainerMemory",
    _field("memory_type", 1, _F.TYPE_STRING),
    _field("size", 2, _F.TYPE_UINT64),
    _field("topology", 3, _F.TYPE_MESSAGE, type_name=".v1.TopologyInfo"),
)
_message(
    "ContainerDevices",
    _field("resource_name", 1, _F.TYPE_STRING),
    _field("device_ids", 2, _F.TYPE_STRING, _F.LABEL_REPEATED),
    _field("topology", 3, _F.TYPE_MESSAGE, type_name=".v1.TopologyInfo"),
)
_message(
    "TopologyInfo",
    _field("nodes", 1, _F.TYPE_MESSAGE, _F.LABEL_REPEATED, ".v1.NUMANode"),
)
_message("NUMANode", _field("ID", 1, _F.TYPE_INT64))
_message(
    "GetPodResourcesRequest",
    _field("pod_name", 1, _F.TYPE_STRING),
    _field("pod_namespace", 2, _F.TYPE_STRING),
)
_message(
    "GetPodResourcesResponse",
    _field("pod_resources", 1, _F.TYPE_MESSAGE, type_name=".v1.PodResources"),
)

_svc = _fdp.service.add(name="PodResourcesLister")
_svc.method.add(
    name="List",
    input_type=".v1.ListPodResourcesRequest",
    output_type=".v1.ListPodResourcesResponse",
)
_svc.method.add(
    name="GetAllocatableResources",
    input_type=".v1.AllocatableResourcesRequest",
    output_type=".v1.AllocatableResourcesResponse",
)
_svc.method.add(
    name="Get",
    input_type=".v1.GetPodResourcesRequest",
    output_type=".v1.GetPodResourcesResponse",
)

DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(_fdp.SerializeToString())
_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, "podresources_pb2", globals())
