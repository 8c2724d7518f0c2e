// JNI binding (reference encoder_jni.c:5-22, built by `make jni`,
// Makefile:31-32): exports
//   Java_com_example_Encoder_mpegEncodeProcedure(env, obj,
//       imagesFolder, bitstreamFolder, videoPath, qualityFactor)
// for the companion Android app, marshalling the three jstrings and
// delegating to mpeg_encode_procedure() exactly as the reference does.
//
// The build ships no JDK headers, so the (stable, documented) subset of the
// JNI ABI used here is declared inline, C-style: JNIEnv* is a pointer to
// a pointer to the interface function table, in which GetStringUTFChars
// and ReleaseStringUTFChars sit at indices 169 and 170 (JNI spec
// "Interface Function Table" — 4 reserved slots, then functions in spec
// order from GetVersion at 4).  The layout below is ABI-compatible with
// any conforming JVM's JNIEnv; tests/test_torch_capi.py drives the export
// through a table constructed at those indices.

#include <cstdint>

extern "C" {

struct _ec504_jobject;
typedef _ec504_jobject *jobject;
typedef jobject jstring;
typedef int32_t jint;
typedef uint8_t jboolean;

struct JNINativeInterface_;
typedef const JNINativeInterface_ *JNIEnv;

struct JNINativeInterface_ {
  void *reserved0;
  void *reserved1;
  void *reserved2;
  void *reserved3;
  void *functions_4_to_168[165];  // GetVersion .. GetStringUTFLength
  const char *(*GetStringUTFChars)(JNIEnv *env, jstring str,
                                   jboolean *isCopy);  // index 169
  void (*ReleaseStringUTFChars)(JNIEnv *env, jstring str,
                                const char *chars);  // index 170
};

int mpeg_encode_procedure(const char *images_folder,
                          const char *bitstream_folder, const char *video_path,
                          int quality_factor);

// Same class/method binding as the reference (encoder_jni.c:5-6).
__attribute__((visibility("default"))) jint
Java_com_example_Encoder_mpegEncodeProcedure(JNIEnv *env, jobject /*obj*/,
                                             jstring images_folder,
                                             jstring bitstream_folder,
                                             jstring video_path,
                                             jint quality_factor) {
  const char *images = (*env)->GetStringUTFChars(env, images_folder, nullptr);
  const char *bits = (*env)->GetStringUTFChars(env, bitstream_folder, nullptr);
  const char *video = (*env)->GetStringUTFChars(env, video_path, nullptr);

  int rc = 1;
  if (images && bits && video)
    rc = mpeg_encode_procedure(images, bits, video, quality_factor);

  if (images) (*env)->ReleaseStringUTFChars(env, images_folder, images);
  if (bits) (*env)->ReleaseStringUTFChars(env, bitstream_folder, bits);
  if (video) (*env)->ReleaseStringUTFChars(env, video_path, video);
  return rc;
}

}  // extern "C"
