"""Serving (counterpart of ``mxnet_tpu/serving``): the one-shot batching
engine and the continuous-batching decode engine."""
from .admission import (AdmissionController, Request, QueueFullError,
                        DeadlineExceededError, ServerOverloadError,
                        EngineClosedError)
from .buckets import BucketPolicy, ProgramCache, pad_valid_lengths
from .engine import ServingEngine
from .decode import (DecodeEngine, DecodeResult, StepProgram, greedy_decode,
                     Sampler, GreedySampler, TemperatureSampler)
