"""Inference engine — the AnalysisPredictor contract
(``paddle/fluid/inference/api/analysis_predictor.h:46``; counterpart
``paddle_tpu/fluid/inference/__init__.py``).

Reference pipeline: load ProgramDesc + params → analysis pass manager
(``inference/analysis/ir_pass_manager.cc``) → execute with
NaiveExecutor.  Here the predictor is: ``load_inference_model`` into a
private scope → program passes (``ir.py``: conv-bn fold, dropout strip)
→ ``Executor.run``, whose dispatch plan is cached per feed signature.
``clone()`` shares the program, weights, scope and executor, serving the
multi-thread deployment pattern (``inference/api/demo_ci``).

``Config`` runs on the card by default: ``enable_use_gpu(device_id=)``
picks the card, ``disable_gpu()`` the CPU.
"""

import numpy as np

from .. import io as fluid_io
from ..executor import CPUPlace, CUDAPlace, Executor, Scope, scope_guard
from ..framework import Variable
from ..ir import apply_passes, DEFAULT_INFERENCE_PASSES

__all__ = ["Config", "AnalysisConfig", "AnalysisPredictor",
           "create_paddle_predictor", "PaddleTensor"]


class Config:
    """AnalysisConfig analogue (inference/api/paddle_analysis_config.h)."""

    def __init__(self, model_dir=None, prog_file=None, params_file=None):
        self.model_dir = model_dir
        self.prog_file = prog_file
        self.params_file = params_file
        self._use_gpu = True
        self._device_id = 0
        self._ir_optim = True
        self._passes = list(DEFAULT_INFERENCE_PASSES)

    # -- device -----------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._use_gpu = True
        self._device_id = int(device_id)

    def disable_gpu(self):
        self._use_gpu = False

    def use_gpu(self):
        return self._use_gpu

    def place(self):
        return CUDAPlace(self._device_id) if self._use_gpu else CPUPlace()

    # -- IR optimization ---------------------------------------------------
    def enable_int8(self):
        raise NotImplementedError(
            "enable_int8 needs int8_execute_pass and the quant ops, which "
            "the port has not yet (ROADMAP queue 1 item 13)")

    def switch_ir_optim(self, flag=True):
        self._ir_optim = flag

    def ir_optim(self):
        return self._ir_optim

    def pass_builder(self):
        return self._passes

    def delete_pass(self, name):
        if name in self._passes:
            self._passes.remove(name)


AnalysisConfig = Config


class PaddleTensor:
    """Minimal input/output carrier (inference/api/paddle_api.h)."""

    def __init__(self, data=None, name=None):
        self.name = name
        self.data = np.asarray(data) if data is not None else None

    def as_ndarray(self):
        return self.data


class AnalysisPredictor:
    def __init__(self, config, _shared=None):
        self._config = config
        if _shared is not None:
            # clone(): share program/scope/executor (weights + dispatch
            # plans), reference AnalysisPredictor::Clone semantics
            (self._program, self._feed_names, self._fetch_vars,
             self._scope, self._exe) = _shared
            return
        self._exe = Executor(config.place())
        self._scope = Scope()
        with scope_guard(self._scope):
            program, feed_names, fetch_vars = fluid_io.load_inference_model(
                config.model_dir, self._exe,
                model_filename=config.prog_file,
                params_filename=config.params_file)
        if config.ir_optim():
            apply_passes(program, self._scope, config.pass_builder())
        self._program = program
        self._feed_names = feed_names
        self._fetch_vars = fetch_vars

    # -- run ---------------------------------------------------------------
    def run(self, inputs):
        """inputs: list of arrays/PaddleTensors in feed order, or a dict.
        Returns a list of numpy arrays, fetch order."""
        if isinstance(inputs, dict):
            feed = {k: (v.as_ndarray() if isinstance(v, PaddleTensor) else v)
                    for k, v in inputs.items()}
        else:
            arrays = [v.as_ndarray() if isinstance(v, PaddleTensor) else v
                      for v in inputs]
            feed = dict(zip(self._feed_names, arrays))
        return self._exe.run(self._program, feed=feed,
                             fetch_list=list(self._fetch_vars),
                             scope=self._scope)

    def clone(self):
        return AnalysisPredictor(
            self._config,
            _shared=(self._program, self._feed_names, self._fetch_vars,
                     self._scope, self._exe))

    # -- introspection -----------------------------------------------------
    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return [v.name if isinstance(v, Variable) else v
                for v in self._fetch_vars]

    def program(self):
        return self._program


def create_paddle_predictor(config):
    """Factory (inference/api/api_impl.cc CreatePaddlePredictor)."""
    return AnalysisPredictor(config)
