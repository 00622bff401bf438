"""The KServe-v2 gRPC protocol of the port: byte-for-byte copies of the
generated ``grpc_service_pb2`` and ``model_config_pb2`` modules (the
serialized descriptors included, so they coexist with any other copy in
protobuf's default descriptor pool), and the server side of the method
table (``service.SERVICE``, ``service.METHODS``).

Importing this package does not import ``grpc``: the pb2 modules need
only ``google.protobuf``."""
