"""The port's models: llama generation (``llama``, ``llama_serving``),
the fixture models (``simple``) and the vision zoo (``vision``).

``default_models()`` and ``serving_models()`` are the counterparts of
``tpuserver/models/__init__.py``'s.  The BERT ensemble is not ported yet,
so ``serving_models`` has no ``include_bert``."""


def default_models():
    """The fixture models."""
    from tpuserver_torch.models.simple import (
        DelayedIdentityModel,
        IdentityBF16Model,
        IdentityFP32Model,
        IdentityStringModel,
        RepeatModel,
        SequenceAccumulateModel,
        SimpleModel,
        SimpleStringModel,
    )

    return [SimpleModel(), SimpleStringModel(), IdentityFP32Model(),
            IdentityBF16Model(), IdentityStringModel(),
            DelayedIdentityModel(), SequenceAccumulateModel(),
            RepeatModel()]


def serving_models(include_vision=True, include_llama=True, device=None,
                   seed=0, llama_cfg=None, llama_max_seq=512,
                   llama_decode_chunk=None, llama_quantize=False,
                   llama_max_slots=1):
    """The serving zoo of the BASELINE configs on ``device`` (the card
    unless the caller asks for the CPU), weights drawn from ``seed``:
    ResNet-50, DenseNet-121, the image preprocess model and the image
    ensemble, and decoupled llama generation (``llama_max_slots > 1``:
    the continuous-batching scheduler)."""
    models = []
    if include_vision:
        from tpuserver_torch.models.vision import vision_models

        models += vision_models(device=device, seed=seed)
    if include_llama:
        from tpuserver_torch.models.llama_serving import LlamaGenerateModel

        models.append(LlamaGenerateModel(
            cfg=llama_cfg, max_seq=llama_max_seq,
            decode_chunk=llama_decode_chunk, seed=seed, device=device,
            quantize=llama_quantize, max_slots=llama_max_slots))
    return models
