"""KServe-v2 gRPC service method table, server side.

There is no generated ``*_pb2_grpc.py``: the server registers every
method of this table with ``grpc.method_handlers_generic_handler``, and a
client builds ``channel.unary_unary``/``stream_stream`` callables from it
(``method_path``).  The method set is the reference's
``GRPCInferenceService``, plus the ``XlaSharedMemory*`` verbs of the
TPU-native service and ``ServerMetrics``.
"""

from . import grpc_service_pb2 as pb

SERVICE = "inference.GRPCInferenceService"

# name -> (request class, response class, kind) where kind is "unary" or
# "stream" (bidi stream-stream).
METHODS = {
    "ServerLive": (pb.ServerLiveRequest, pb.ServerLiveResponse, "unary"),
    "ServerReady": (pb.ServerReadyRequest, pb.ServerReadyResponse, "unary"),
    "ModelReady": (pb.ModelReadyRequest, pb.ModelReadyResponse, "unary"),
    "ServerMetadata": (
        pb.ServerMetadataRequest, pb.ServerMetadataResponse, "unary"),
    # the Prometheus text exposition on the gRPC transport: it rides a
    # LogSettingsResponse string param ("metrics") and takes a
    # ServerMetadataRequest, since the serialized descriptors cannot grow
    # a new message without protoc
    "ServerMetrics": (
        pb.ServerMetadataRequest, pb.LogSettingsResponse, "unary"),
    "ModelMetadata": (
        pb.ModelMetadataRequest, pb.ModelMetadataResponse, "unary"),
    "ModelInfer": (pb.ModelInferRequest, pb.ModelInferResponse, "unary"),
    "ModelStreamInfer": (
        pb.ModelInferRequest, pb.ModelStreamInferResponse, "stream"),
    "ModelConfig": (pb.ModelConfigRequest, pb.ModelConfigResponse, "unary"),
    "ModelStatistics": (
        pb.ModelStatisticsRequest, pb.ModelStatisticsResponse, "unary"),
    "RepositoryIndex": (
        pb.RepositoryIndexRequest, pb.RepositoryIndexResponse, "unary"),
    "RepositoryModelLoad": (
        pb.RepositoryModelLoadRequest, pb.RepositoryModelLoadResponse,
        "unary"),
    "RepositoryModelUnload": (
        pb.RepositoryModelUnloadRequest, pb.RepositoryModelUnloadResponse,
        "unary"),
    "SystemSharedMemoryStatus": (
        pb.SystemSharedMemoryStatusRequest,
        pb.SystemSharedMemoryStatusResponse, "unary"),
    "SystemSharedMemoryRegister": (
        pb.SystemSharedMemoryRegisterRequest,
        pb.SystemSharedMemoryRegisterResponse, "unary"),
    "SystemSharedMemoryUnregister": (
        pb.SystemSharedMemoryUnregisterRequest,
        pb.SystemSharedMemoryUnregisterResponse, "unary"),
    "CudaSharedMemoryStatus": (
        pb.CudaSharedMemoryStatusRequest, pb.CudaSharedMemoryStatusResponse,
        "unary"),
    "CudaSharedMemoryRegister": (
        pb.CudaSharedMemoryRegisterRequest,
        pb.CudaSharedMemoryRegisterResponse, "unary"),
    "CudaSharedMemoryUnregister": (
        pb.CudaSharedMemoryUnregisterRequest,
        pb.CudaSharedMemoryUnregisterResponse, "unary"),
    "XlaSharedMemoryStatus": (
        pb.XlaSharedMemoryStatusRequest, pb.XlaSharedMemoryStatusResponse,
        "unary"),
    "XlaSharedMemoryRegister": (
        pb.XlaSharedMemoryRegisterRequest,
        pb.XlaSharedMemoryRegisterResponse, "unary"),
    "XlaSharedMemoryUnregister": (
        pb.XlaSharedMemoryUnregisterRequest,
        pb.XlaSharedMemoryUnregisterResponse, "unary"),
    "TraceSetting": (
        pb.TraceSettingRequest, pb.TraceSettingResponse, "unary"),
    "LogSettings": (pb.LogSettingsRequest, pb.LogSettingsResponse, "unary"),
}


def method_path(name):
    return "/{}/{}".format(SERVICE, name)
