#!/usr/bin/env python3
"""Token-by-token generation over the decoupled gRPC stream with the data
plane in CUDA regions (BASELINE config #5 on a CUDA card): the prompt by
shared-memory reference and every TOKEN/LOGPROB in a token ring of one
CUDA region (``--mode ring``), or the KV cache parked in a CUDA region
between two requests, the second continuing from it (``--mode
kv-park``).

The regions come from ``tpuserver_torch.cuda_shared_memory`` and are
registered with ``register_cuda_shared_memory`` by their raw handle; the
server maps them over CUDA IPC.  A park holds the model's whole KV cache
(``2 * n_layers * max_seq * n_kv_heads * head_dim`` values), so
``--kv-bytes`` sizes its region: 512 MiB, the default, is ``llama3_8b``'s
at ``max_seq`` 4096 in bf16.  It needs a CUDA card on the client's host,
the server's card: without one it exits 2 before it registers anything.

    PYTHONPATH=src/python python src/python/examples/\\
llama_streaming_cudashm_client.py -u localhost:8001 --mode ring
"""

import argparse
import sys

import numpy as np

import tritonclient.grpc as grpcclient

# the exit code when this host has no CUDA card
NO_CARD = 2
# llama3_8b's KV cache at max_seq 4096 in bf16: 2 x 32 layers x 4096
# positions x 8 kv heads x 128 x 2 bytes
LLAMA3_8B_KV_BYTES = 512 << 20
PROMPT = [1, 5, 9, 13]
# the ring's first slot: the prompt lies at offset 0 below it
RING_BASE = 64


def _positive(text):
    value = int(text)
    if value <= 0:
        raise argparse.ArgumentTypeError("must be positive: {}".format(text))
    return value


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-u", "--url", default="localhost:8001")
    parser.add_argument("-n", "--max-tokens", type=_positive, default=8)
    parser.add_argument("--mode", choices=["ring", "kv-park"],
                        default="kv-park",
                        help="ring: the prompt by reference and the tokens "
                             "in a token ring, checked against an in-band "
                             "generation; kv-park: park the KV cache in a "
                             "region and continue from it")
    parser.add_argument("--kv-bytes", type=_positive,
                        default=LLAMA3_8B_KV_BYTES,
                        help="the KV-park region's bytes (at least the "
                             "served model's whole KV cache)")
    parser.add_argument("--device-id", type=int, default=0,
                        help="the card the regions are made on")
    return parser.parse_args(argv)


def generate(client, prompt, max_tokens, parameters=None):
    """The greedy tokens of one generation, in band."""
    p_in = grpcclient.InferInput("PROMPT_IDS", [len(prompt)], "INT32")
    p_in.set_data_from_numpy(np.asarray(prompt, dtype=np.int32))
    m_in = grpcclient.InferInput("MAX_TOKENS", [1], "INT32")
    m_in.set_data_from_numpy(np.array([max_tokens], dtype=np.int32))
    tokens = []
    for result in client.generate_stream(
            "llama_generate", [p_in, m_in], parameters=parameters,
            on_reconnect=lambda attempt, exc: print(
                "reconnect {} after: {}".format(attempt, exc), flush=True)):
        token = int(result.as_numpy("TOKEN")[0])
        tokens.append(token)
        print("token:", token, flush=True)
    return tokens


def create_region(cudashm, name, size, device_id):
    """A region on card ``device_id``, or None after a FAILED line when
    this host has no card."""
    try:
        return cudashm.create_shared_memory_region(name, size, device_id)
    except (RuntimeError, cudashm.CudaSharedMemoryException) as e:
        print("FAILED: CUDA shared memory needs a CUDA card on this host: "
              "{}".format(e))
        return None


def generate_ring(client, cudashm, region, prompt, max_tokens, device_id):
    """The prompt by reference at offset 0 of ``region`` and one ring slot
    (TOKEN, LOGPROB; 8 bytes) a token from ``RING_BASE``: the responses
    carry only ``seq -> offset`` descriptors, and the tokens are read
    from the ring."""
    prompt = np.asarray(prompt, dtype=np.int32)
    size = RING_BASE + 8 * max_tokens
    cudashm.set_shared_memory_region(region, [prompt])
    client.register_cuda_shared_memory(
        "llama_shm_plane", cudashm.get_raw_handle(region), device_id, size)
    try:
        p_in = grpcclient.InferInput("PROMPT_IDS", [len(prompt)], "INT32")
        p_in.set_shared_memory("llama_shm_plane", prompt.nbytes, 0)
        m_in = grpcclient.InferInput("MAX_TOKENS", [1], "INT32")
        m_in.set_data_from_numpy(np.array([max_tokens], dtype=np.int32))
        events = 0
        for _result in client.generate_stream(
                "llama_generate", [p_in, m_in],
                parameters={"shm_ring_region": "llama_shm_plane",
                            "shm_ring_slots": max_tokens,
                            "shm_ring_offset": RING_BASE}):
            events += 1  # a descriptor-only event; the tensors are in the ring
        tokens = [int(cudashm.get_contents_as_numpy(
            region, "INT32", [1], RING_BASE + 8 * s)[0])
            for s in range(events)]
        print("ring tokens:", tokens, flush=True)
        return tokens
    finally:
        client.unregister_cuda_shared_memory("llama_shm_plane")


def main(argv=None):
    args = parse_args(argv)
    from tpuserver_torch import cuda_shared_memory as cudashm

    if args.mode == "ring":
        name, size = "llama_shm_plane", RING_BASE + 8 * args.max_tokens
    else:
        name, size = "llama_kv_park", args.kv_bytes
    region = create_region(cudashm, name, size, args.device_id)
    if region is None:
        sys.exit(NO_CARD)
    client = grpcclient.InferenceServerClient(args.url)
    try:
        if args.mode == "ring":
            # token identity across planes: the in-band stream and the
            # ring carry the same greedy tokens
            inband = generate(client, PROMPT, args.max_tokens)
            ring = generate_ring(client, cudashm, region, PROMPT,
                                 args.max_tokens, args.device_id)
            if ring != inband:
                print("FAILED: ring tokens diverged from in-band")
                sys.exit(1)
            print("PASS: llama streaming (cuda shared memory ring)")
            return
        client.register_cuda_shared_memory(
            name, cudashm.get_raw_handle(region), args.device_id, size)
        try:
            # first pass: prefill and generate, parking the finished KV
            # cache (prompt + the generated tokens)
            first = generate(client, PROMPT, args.max_tokens,
                             parameters={"kv_cache_region": name})
            # resumed pass: the parked cache holds the history, so only
            # the new tokens go in, with the position the cache was left at
            resumed = generate(
                client, [2, 6], args.max_tokens,
                parameters={"kv_cache_region": name,
                            "kv_cache_resume": True,
                            "kv_cache_position": len(PROMPT) + len(first)})
        finally:
            client.unregister_cuda_shared_memory(name)
        print("first:", first)
        print("resumed:", resumed)
        if len(first) != args.max_tokens or len(resumed) != args.max_tokens:
            print("FAILED: wrong token counts")
            sys.exit(1)
        print("PASS: llama streaming (cuda shared memory kv park)")
    finally:
        cudashm.destroy_shared_memory_region(region)
        client.close()


if __name__ == "__main__":
    main()
