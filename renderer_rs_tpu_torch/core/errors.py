"""Error hierarchy (≙ renderer_rs_tpu/core/errors.py; crates/core/src/
error.rs:7-38, rhi/src/error.rs:6-50, resources/src/error.rs:8-40): every
subsystem raises a subclass of RendererError."""


class RendererError(Exception):
    """Base error for the whole framework (≙ core::Error)."""


class WindowError(RendererError):
    """Windowing / surface errors (≙ Error::Window)."""


class RhiError(RendererError):
    """Software-GPU layer errors (≙ rhi::RhiError)."""


class PipelineError(RhiError):
    """Pipeline construction/validation errors (≙ RhiError::Pipeline)."""


class ShaderError(RendererError):
    """Shading-pass configuration errors (≙ Error::Shader / RhiError::Shader)."""


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


class ConfigError(RendererError):
    """Configuration errors (≙ Error::Config)."""


class InternalError(RendererError):
    """Internal invariant violations (≙ Error::Internal)."""
