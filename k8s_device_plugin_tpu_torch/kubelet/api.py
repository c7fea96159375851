"""Hand-written gRPC bindings for the v1beta1 device-plugin contract.

The port's own copy of the JAX package's ``kubelet/api.py`` (the port
imports nothing of that package); the method paths are unchanged.

grpcio is installed without grpcio-tools in this environment, so instead of
protoc-generated service stubs we bind the (protoc-generated) message classes
to gRPC method paths ourselves.  The method paths are fixed by the proto
package/service/method names and match what the kubelet dials/serves
(reference wire contract: vendored deviceplugin/v1beta1/api.proto:23-67 and
its generated api.pb.go bindings).

Works with both `grpc` (sync) and `grpc.aio` channels/servers: generic
handlers are accepted by both server flavors, and `channel.unary_unary`/
`unary_stream` exist on both channel flavors.
"""

from __future__ import annotations

import grpc

from . import deviceplugin_pb2 as pb
from . import podresources_pb2 as prpb
from .constants import (
    DEVICE_PLUGIN_SERVICE,
    POD_RESOURCES_SERVICE,
    REGISTRATION_SERVICE,
)

__all__ = [
    "pb",
    "prpb",
    "RegistrationStub",
    "DevicePluginStub",
    "PodResourcesListerStub",
    "add_registration_servicer",
    "add_device_plugin_servicer",
    "add_pod_resources_servicer",
]


class RegistrationStub:
    """Client for the kubelet's Registration service (plugin -> kubelet)."""

    def __init__(self, channel: grpc.Channel):
        self.Register = channel.unary_unary(
            f"/{REGISTRATION_SERVICE}/Register",
            request_serializer=pb.RegisterRequest.SerializeToString,
            response_deserializer=pb.Empty.FromString,
        )


class DevicePluginStub:
    """Client for a plugin's DevicePlugin service (kubelet -> plugin).

    Used by our hermetic fake kubelet in tests; a real kubelet holds the
    equivalent generated client.
    """

    def __init__(self, channel: grpc.Channel):
        self.GetDevicePluginOptions = channel.unary_unary(
            f"/{DEVICE_PLUGIN_SERVICE}/GetDevicePluginOptions",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.DevicePluginOptions.FromString,
        )
        self.ListAndWatch = channel.unary_stream(
            f"/{DEVICE_PLUGIN_SERVICE}/ListAndWatch",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.ListAndWatchResponse.FromString,
        )
        self.GetPreferredAllocation = channel.unary_unary(
            f"/{DEVICE_PLUGIN_SERVICE}/GetPreferredAllocation",
            request_serializer=pb.PreferredAllocationRequest.SerializeToString,
            response_deserializer=pb.PreferredAllocationResponse.FromString,
        )
        self.Allocate = channel.unary_unary(
            f"/{DEVICE_PLUGIN_SERVICE}/Allocate",
            request_serializer=pb.AllocateRequest.SerializeToString,
            response_deserializer=pb.AllocateResponse.FromString,
        )
        self.PreStartContainer = channel.unary_unary(
            f"/{DEVICE_PLUGIN_SERVICE}/PreStartContainer",
            request_serializer=pb.PreStartContainerRequest.SerializeToString,
            response_deserializer=pb.PreStartContainerResponse.FromString,
        )


class PodResourcesListerStub:
    """Client for the kubelet's PodResourcesLister service (plugin -> kubelet).

    Dialed on ``pod-resources/kubelet.sock`` (constants.POD_RESOURCES_SOCKET)
    by plugin/attribution.py; the hermetic FakeKubelet serves the same
    service in tests.
    """

    def __init__(self, channel: grpc.Channel):
        self.List = channel.unary_unary(
            f"/{POD_RESOURCES_SERVICE}/List",
            request_serializer=prpb.ListPodResourcesRequest.SerializeToString,
            response_deserializer=prpb.ListPodResourcesResponse.FromString,
        )
        self.GetAllocatableResources = channel.unary_unary(
            f"/{POD_RESOURCES_SERVICE}/GetAllocatableResources",
            request_serializer=prpb.AllocatableResourcesRequest.SerializeToString,
            response_deserializer=prpb.AllocatableResourcesResponse.FromString,
        )
        self.Get = channel.unary_unary(
            f"/{POD_RESOURCES_SERVICE}/Get",
            request_serializer=prpb.GetPodResourcesRequest.SerializeToString,
            response_deserializer=prpb.GetPodResourcesResponse.FromString,
        )


def add_registration_servicer(servicer, server) -> None:
    """Register a Registration servicer (an object with .Register) on a server."""
    handlers = {
        "Register": grpc.unary_unary_rpc_method_handler(
            servicer.Register,
            request_deserializer=pb.RegisterRequest.FromString,
            response_serializer=pb.Empty.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(REGISTRATION_SERVICE, handlers),)
    )


def add_device_plugin_servicer(servicer, server) -> None:
    """Register a DevicePlugin servicer on a server.

    `servicer` provides GetDevicePluginOptions, ListAndWatch (server-streaming),
    Allocate, and PreStartContainer.
    """
    handlers = {
        "GetDevicePluginOptions": grpc.unary_unary_rpc_method_handler(
            servicer.GetDevicePluginOptions,
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.DevicePluginOptions.SerializeToString,
        ),
        "ListAndWatch": grpc.unary_stream_rpc_method_handler(
            servicer.ListAndWatch,
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.ListAndWatchResponse.SerializeToString,
        ),
        "GetPreferredAllocation": grpc.unary_unary_rpc_method_handler(
            servicer.GetPreferredAllocation,
            request_deserializer=pb.PreferredAllocationRequest.FromString,
            response_serializer=pb.PreferredAllocationResponse.SerializeToString,
        ),
        "Allocate": grpc.unary_unary_rpc_method_handler(
            servicer.Allocate,
            request_deserializer=pb.AllocateRequest.FromString,
            response_serializer=pb.AllocateResponse.SerializeToString,
        ),
        "PreStartContainer": grpc.unary_unary_rpc_method_handler(
            servicer.PreStartContainer,
            request_deserializer=pb.PreStartContainerRequest.FromString,
            response_serializer=pb.PreStartContainerResponse.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(DEVICE_PLUGIN_SERVICE, handlers),)
    )


def add_pod_resources_servicer(servicer, server) -> None:
    """Register a PodResourcesLister servicer (List, GetAllocatableResources,
    Get) on a server — what the hermetic FakeKubelet uses to stand in for
    the real kubelet's pod-resources endpoint."""
    handlers = {
        "List": grpc.unary_unary_rpc_method_handler(
            servicer.List,
            request_deserializer=prpb.ListPodResourcesRequest.FromString,
            response_serializer=prpb.ListPodResourcesResponse.SerializeToString,
        ),
        "GetAllocatableResources": grpc.unary_unary_rpc_method_handler(
            servicer.GetAllocatableResources,
            request_deserializer=prpb.AllocatableResourcesRequest.FromString,
            response_serializer=prpb.AllocatableResourcesResponse.SerializeToString,
        ),
        "Get": grpc.unary_unary_rpc_method_handler(
            servicer.Get,
            request_deserializer=prpb.GetPodResourcesRequest.FromString,
            response_serializer=prpb.GetPodResourcesResponse.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(POD_RESOURCES_SERVICE, handlers),)
    )
