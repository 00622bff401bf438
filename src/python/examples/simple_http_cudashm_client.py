#!/usr/bin/env python3
"""CUDA shared-memory data plane over HTTP (the reference's
simple_http_cudashm_client; the HTTP counterpart of
``simple_grpc_cudashm_client.py``): INPUT0 and INPUT1 of the ``simple``
model lie in one CUDA region, OUTPUT0 and OUTPUT1 land in a second, and
the server maps both over CUDA IPC from their raw handles.

The regions come from ``tpuserver_torch.cuda_shared_memory`` (device
memory from ``cudaMalloc``; the raw handle is the base64 of its 64-byte
``cudaIpcMemHandle_t``, Triton's own format) and are registered with
``register_cuda_shared_memory``.  It needs a CUDA card on the client's
host, the server's card: without one it exits 2 before it registers
anything.

    PYTHONPATH=src/python python src/python/examples/\\
simple_http_cudashm_client.py -u localhost:8000
"""

import argparse
import sys

import numpy as np

import tritonclient.http as httpclient

# the exit code when this host has no CUDA card
NO_CARD = 2


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("-u", "--url", default="localhost:8000")
    parser.add_argument("--device-id", type=int, default=0,
                        help="the card the regions are made on")
    return parser.parse_args(argv)


def create_regions(cudashm, specs, device_id):
    """One region per (name, bytes) of ``specs``, on card ``device_id``;
    None, after a FAILED line, when this host has no card."""
    handles = []
    try:
        for name, size in specs:
            handles.append(cudashm.create_shared_memory_region(
                name, size, device_id))
    except (RuntimeError, cudashm.CudaSharedMemoryException) as e:
        for handle in handles:
            cudashm.destroy_shared_memory_region(handle)
        print("FAILED: CUDA shared memory needs a CUDA card on this host: "
              "{}".format(e))
        return None
    return handles


def main(argv=None):
    args = parse_args(argv)
    from tpuserver_torch import cuda_shared_memory as cudashm

    client = httpclient.InferenceServerClient(url=args.url,
                                              verbose=args.verbose)
    client.unregister_cuda_shared_memory()

    input0_data = np.arange(16, dtype=np.int32).reshape(1, 16)
    input1_data = np.full((1, 16), 1, dtype=np.int32)
    byte_size = 16 * 4

    handles = create_regions(cudashm, [("input_data", byte_size * 2),
                                       ("output_data", byte_size * 2)],
                             args.device_id)
    if handles is None:
        client.close()
        sys.exit(NO_CARD)
    shm_ip_handle, shm_op_handle = handles
    try:
        client.register_cuda_shared_memory(
            "input_data", cudashm.get_raw_handle(shm_ip_handle),
            args.device_id, byte_size * 2)
        client.register_cuda_shared_memory(
            "output_data", cudashm.get_raw_handle(shm_op_handle),
            args.device_id, byte_size * 2)
        cudashm.set_shared_memory_region(shm_ip_handle,
                                         [input0_data, input1_data])

        inputs = [
            httpclient.InferInput("INPUT0", [1, 16], "INT32"),
            httpclient.InferInput("INPUT1", [1, 16], "INT32"),
        ]
        inputs[0].set_shared_memory("input_data", byte_size)
        inputs[1].set_shared_memory("input_data", byte_size,
                                    offset=byte_size)
        outputs = [
            httpclient.InferRequestedOutput("OUTPUT0"),
            httpclient.InferRequestedOutput("OUTPUT1"),
        ]
        outputs[0].set_shared_memory("output_data", byte_size)
        outputs[1].set_shared_memory("output_data", byte_size,
                                     offset=byte_size)

        client.infer("simple", inputs, outputs=outputs)

        output0_data = cudashm.get_contents_as_numpy(
            shm_op_handle, np.int32, [1, 16])
        output1_data = cudashm.get_contents_as_numpy(
            shm_op_handle, np.int32, [1, 16], offset=byte_size)
        for i in range(16):
            print("{} + {} = {}".format(input0_data[0][i],
                                        input1_data[0][i],
                                        output0_data[0][i]))
            print("{} - {} = {}".format(input0_data[0][i],
                                        input1_data[0][i],
                                        output1_data[0][i]))
        if not np.array_equal(output0_data, input0_data + input1_data):
            print("FAILED: incorrect sum in cuda shm")
            sys.exit(1)
        if not np.array_equal(output1_data, input0_data - input1_data):
            print("FAILED: incorrect difference in cuda shm")
            sys.exit(1)
        status = client.get_cuda_shared_memory_status()
        if len(status) < 2:
            print("FAILED: cuda shm status missing regions")
            sys.exit(1)
    finally:
        client.unregister_cuda_shared_memory()
        cudashm.destroy_shared_memory_region(shm_ip_handle)
        cudashm.destroy_shared_memory_region(shm_op_handle)
        client.close()
    print("PASS: cuda shared memory")
    return 0


if __name__ == "__main__":
    sys.exit(main())
