"""Error hierarchy (the subset of renderer_rs_tpu/core/errors.py the port
raises): the renderer's base class, the RHI errors, and the resource
loaders' errors (≙ resources::ResourceError, resources/src/error.rs:8-40)."""


class RendererError(Exception):
    """Base error for the whole framework (≙ core::Error)."""


class RhiError(RendererError):
    """Software-GPU layer errors (≙ rhi::RhiError)."""


class PipelineError(RhiError):
    """Pipeline construction/validation errors (≙ RhiError::Pipeline)."""


class ResourceError(RendererError):
    """Asset loading errors (≙ resources::ResourceError)."""


class GltfLoadError(ResourceError):
    """glTF import failures (≙ ResourceError::GltfLoad)."""


class NoMeshesError(ResourceError):
    """Model contained no meshes (≙ ResourceError::NoMeshes)."""


class NoPositionDataError(ResourceError):
    """A primitive had no POSITION accessor (≙ ResourceError::NoPositionData)."""


class FileNotFoundError_(ResourceError):
    """Asset path does not exist (≙ ResourceError::FileNotFound)."""


class ImageError(ResourceError):
    """Texture/image decode errors (≙ ResourceError::Image)."""
