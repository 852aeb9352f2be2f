"""fastvision_tpu_torch: the PyTorch + CUDA port of fastvision_tpu.

The JAX package `fastvision_tpu` is the reference; this package mirrors its
file layout so each module has an obvious counterpart, and imports neither
JAX nor anything of the JAX package. Entry points run on CUDA unless the
caller passes ``device="cpu"``.

Ported: the YOLOv3 and Faster R-CNN detectors, the classification and
video zoos, the data pipeline and its worker pools, the losses, `train.Fit`
with checkpoints and resume, `infer.Detector` (its input paths, evaluation
and int8 quantization), serving, program export (`infer.export`: a
``torch.export`` program with its weights), the host tools (anchors,
converters, plots, telemetry), and every subcommand of the command line
(`cli`). The hand-written CUDA kernels (``csrc/``: greedy NMS, the int8
conv, patches and epilogue) run on CUDA tensors, as ``fastvision::``
custom ops, and their plain PyTorch versions on CPU tensors. Data
parallelism over a ``torch.distributed`` process group (multi-process and
multi-host, `core.distributed` / `core.mesh`, with a global-batch BN and
loss, host-sharded loaders and FSDP, `parallel.fsdp`) runs `train.Fit`, the
evaluators and the train commands, as do tensor parallel and time
sharding over the mesh's model and time axes (`parallel`) and Faster R-CNN
over several ranks; GPipe pipelines run a model's stages over the model
axis (`parallel.pipeline`). ``compile_cache`` keeps the native builds
across restarts (`core.mesh.enable_compile_cache`); annotated videos are
written by the port's own MPEG-4 encoder and MP4 muxer (`data.mp4`), and
videos are read without cv2 in Motion-JPEG AVIs and in MPEG-4 Part 2 (XviD /
DivX / mp4v in AVI, MP4 and MOV: `data.mpeg4`, FFmpeg's frames bit for
bit). Arithmetic-coded and lossless JPEG decode as cv2 5.0 decodes them
(`data.codec`); the JPEG kinds cv2 returns no image for (12-bit, lossless
above 8 bits or YCbCr / gray lossless, hierarchical) raise. Not ported: H.264 and
the other video codecs without cv2, the MPEG-4 tools no encoder at hand
writes (static sprites, RVLC, ...), Matroska / WebM (ROADMAP Queue 1, item
11).
"""

__version__ = "0.1.0"
