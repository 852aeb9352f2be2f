"""A departure pinned: what a resumed YOLOv3 ``Fit`` restores as its step.

The JAX package's ``Fit`` rebuilds the restored state with the fresh
state's step (fastvision_tpu/train/fit.py:164-169), which is 0, so after a
resume the EMA warm-up and the per-step keys restart as at step 0 while its
``global_step`` goes on from the checkpoint. The port restores the saved
step (fastvision_tpu_torch/train/fit.py:173-177). Both packages are cut and
resumed here on the CPU and their restored steps stated side by side.
"""
import jax

from test_fit import det_data, make_yolo_fit  # noqa: F401  (det_data is a fixture)
from test_torch_core import _fit, base_models  # noqa: F401  (base_models is a fixture)


def test_resumed_fit_step_jax_restarts_at_zero_port_keeps_the_saved_step(det_data,
                                                                          base_models,
                                                                          tmp_path):
    jax_fit = make_yolo_fit(det_data, tmp_path / "jax", epochs=1)
    jax_fit.run()
    assert int(jax_fit.global_step) == int(jax_fit.state.step) == 2  # 16 images, batch 8
    resumed = make_yolo_fit(det_data, tmp_path / "jax", epochs=2, resume=True)
    assert (resumed.start_epoch, int(resumed.global_step)) == (1, 2)
    assert int(jax.device_get(resumed.state.step)) == 0  # the fresh state's step

    ckpt = str(tmp_path / "port")
    cut, _ = _fit("yolov3", base_models["yolov3"], ckpt, preempt_after=3)
    cut.run()
    assert cut.interrupted and cut.state.step == 3
    port, _ = _fit("yolov3", base_models["yolov3"], ckpt, resume=True)
    assert (port.start_epoch, port.global_step) == (1, 3)
    assert port.state.step == 3  # the saved step
