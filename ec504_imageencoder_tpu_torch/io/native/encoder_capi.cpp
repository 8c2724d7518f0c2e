// C ABI for embedding (the reference's JNI-binding analogue).
//
// The reference exposes mpeg_encode_procedure() through a shared library
// for its Android app (reference encoder_jni.c:5-22, Makefile sharedlib/
// jni targets).  This port's encode path lives in the Python/PyTorch
// runtime, so the embedding surface is a thin process boundary: this shim
// exports the same C entry point and runs the port's CLI in compat mode
// on the CUDA card (the CLI's default device).  Callers link
// libencoder_compat and call exactly what they called before.  The
// interpreter is $EC504_PYTHON, else python3; the package must be
// importable from the caller's working directory or installed.
//
// Built by io/_native.py with g++ at first use.

#include <cstdio>
#include <cstdlib>
#include <string>

extern "C" {

// Mirrors reference include/encoder.h:20.
int mpeg_encode_procedure(const char *images_folder,
                          const char *bitstream_folder,
                          const char *video_path,
                          int quality_factor) {
  if (!images_folder || !bitstream_folder || !video_path) return 1;
  const char *python = std::getenv("EC504_PYTHON");
  if (!python) python = "python3";

  auto q = [](const std::string &s) {
    std::string out = "'";
    for (char c : s) {
      if (c == '\'')
        out += "'\\''";
      else
        out += c;
    }
    return out + "'";
  };

  std::string cmd = std::string(python) +
                    " -m ec504_imageencoder_tpu_torch.cli " + q(images_folder) +
                    " -o " + q(video_path) + " --mode compat" +
                    " --bitstream-dir " + q(bitstream_folder) + " -q " +
                    std::to_string(quality_factor);
  int rc = std::system(cmd.c_str());
  return rc == 0 ? 0 : 1;
}

}  // extern "C"
