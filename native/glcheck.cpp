// Headless GL executor for the WebGL2 viewer's shaders.
//
// The interactive viewer (hnanosolver_tpu/viewer/webapp.py) ships GLSL ES
// 3.0 shader strings that a browser compiles at page load; this image has
// no browser, so this harness drives the SAME shaders through Mesa's
// surfaceless EGL platform (swrast/llvmpipe) in a real GLES 3.0 context:
// compile + link (hard-fails on any GLSL error), upload the R8 3D density/
// emission textures exactly as the page's texImage3D call does, draw the
// same fullscreen triangle with the same uniform set and camera model, and
// read back a PPM. Shader-in-a-string code that has never executed in a GL
// context is unproven; this harness executes it. Parity target: the reference's GL viewer,
// /root/reference/HNanoViewer/src/HNanoViewer.cpp:106-362.
//
// Everything is resolved at runtime via dlopen/eglGetProcAddress (this
// image ships Mesa runtime libraries but no EGL/GLES headers), so the file
// declares the minimal EGL/GLES ABI it uses.
//
// usage: glcheck vs.glsl fs.glsl volume.r8 W H D out.ppm [az el dist
//        [emit.r8]]

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <dlfcn.h>
#include <string>
#include <vector>

// ---- minimal EGL ABI ----
typedef void* EGLDisplay;
typedef void* EGLContext;
typedef void* EGLConfig;
typedef void* EGLSurface;
typedef int32_t EGLint;
typedef unsigned int EGLBoolean;
typedef unsigned int EGLenum;
#define EGL_NO_DISPLAY nullptr
#define EGL_NO_SURFACE nullptr
#define EGL_NO_CONTEXT nullptr
#define EGL_PLATFORM_SURFACELESS_MESA 0x31DD
#define EGL_OPENGL_ES_API 0x30A0
#define EGL_CONTEXT_MAJOR_VERSION 0x3098
#define EGL_NONE 0x3038
#define EGL_SURFACE_TYPE 0x3033
#define EGL_RENDERABLE_TYPE 0x3040
#define EGL_OPENGL_ES3_BIT 0x0040

// ---- minimal GLES 3.0 ABI ----
typedef unsigned int GLenum;
typedef unsigned int GLuint;
typedef int GLint;
typedef int GLsizei;
typedef unsigned char GLubyte;
typedef float GLfloat;
typedef char GLchar;
typedef unsigned char GLboolean;
typedef intptr_t GLsizeiptr;
#define GL_FRAGMENT_SHADER 0x8B30
#define GL_VERTEX_SHADER 0x8B31
#define GL_COMPILE_STATUS 0x8B81
#define GL_LINK_STATUS 0x8B82
#define GL_ARRAY_BUFFER 0x8892
#define GL_STATIC_DRAW 0x88E4
#define GL_FLOAT 0x1406
#define GL_TRIANGLES 0x0004
#define GL_TEXTURE_3D 0x806F
#define GL_TEXTURE0 0x84C0
#define GL_TEXTURE_MIN_FILTER 0x2801
#define GL_TEXTURE_MAG_FILTER 0x2800
#define GL_TEXTURE_WRAP_S 0x2802
#define GL_TEXTURE_WRAP_T 0x2803
#define GL_TEXTURE_WRAP_R 0x8072
#define GL_LINEAR 0x2601
#define GL_CLAMP_TO_EDGE 0x812F
#define GL_R8 0x8229
#define GL_RED 0x1903
#define GL_UNSIGNED_BYTE 0x1401
#define GL_UNPACK_ALIGNMENT 0x0CF5
#define GL_FRAMEBUFFER 0x8D40
#define GL_COLOR_ATTACHMENT0 0x8CE0
#define GL_RENDERBUFFER 0x8D41
#define GL_RGBA8 0x8058
#define GL_RGBA 0x1908
#define GL_FRAMEBUFFER_COMPLETE 0x8CD5
#define GL_COLOR_BUFFER_BIT 0x00004000

#define E(name, ret, ...) typedef ret (*PFN_##name)(__VA_ARGS__); PFN_##name name;
E(eglGetProcAddress, void*, const char*)
E(eglInitialize, EGLBoolean, EGLDisplay, EGLint*, EGLint*)
E(eglBindAPI, EGLBoolean, EGLenum)
E(eglChooseConfig, EGLBoolean, EGLDisplay, const EGLint*, EGLConfig*, EGLint, EGLint*)
E(eglCreateContext, EGLContext, EGLDisplay, EGLConfig, EGLContext, const EGLint*)
E(eglMakeCurrent, EGLBoolean, EGLDisplay, EGLSurface, EGLSurface, EGLContext)
E(eglGetError, EGLint, void)
typedef EGLDisplay (*PFN_GetPlatformDisplay)(EGLenum, void*, const EGLint*);

E(glCreateShader, GLuint, GLenum)
E(glShaderSource, void, GLuint, GLsizei, const GLchar* const*, const GLint*)
E(glCompileShader, void, GLuint)
E(glGetShaderiv, void, GLuint, GLenum, GLint*)
E(glGetShaderInfoLog, void, GLuint, GLsizei, GLsizei*, GLchar*)
E(glCreateProgram, GLuint, void)
E(glAttachShader, void, GLuint, GLuint)
E(glLinkProgram, void, GLuint)
E(glGetProgramiv, void, GLuint, GLenum, GLint*)
E(glGetProgramInfoLog, void, GLuint, GLsizei, GLsizei*, GLchar*)
E(glUseProgram, void, GLuint)
E(glGenBuffers, void, GLsizei, GLuint*)
E(glBindBuffer, void, GLenum, GLuint)
E(glBufferData, void, GLenum, GLsizeiptr, const void*, GLenum)
E(glGetAttribLocation, GLint, GLuint, const GLchar*)
E(glEnableVertexAttribArray, void, GLuint)
E(glVertexAttribPointer, void, GLuint, GLint, GLenum, GLboolean, GLsizei, const void*)
E(glGetUniformLocation, GLint, GLuint, const GLchar*)
E(glUniform3fv, void, GLint, GLsizei, const GLfloat*)
E(glUniform1f, void, GLint, GLfloat)
E(glUniform1i, void, GLint, GLint)
E(glGenTextures, void, GLsizei, GLuint*)
E(glActiveTexture, void, GLenum)
E(glBindTexture, void, GLenum, GLuint)
E(glTexParameteri, void, GLenum, GLenum, GLint)
E(glTexImage3D, void, GLenum, GLint, GLint, GLsizei, GLsizei, GLsizei, GLint, GLenum, GLenum, const void*)
E(glPixelStorei, void, GLenum, GLint)
E(glGenFramebuffers, void, GLsizei, GLuint*)
E(glBindFramebuffer, void, GLenum, GLuint)
E(glGenRenderbuffers, void, GLsizei, GLuint*)
E(glBindRenderbuffer, void, GLenum, GLuint)
E(glRenderbufferStorage, void, GLenum, GLenum, GLsizei, GLsizei)
E(glFramebufferRenderbuffer, void, GLenum, GLenum, GLenum, GLuint)
E(glCheckFramebufferStatus, GLenum, GLenum)
E(glViewport, void, GLint, GLint, GLsizei, GLsizei)
E(glClearColor, void, GLfloat, GLfloat, GLfloat, GLfloat)
E(glClear, void, unsigned int)
E(glDrawArrays, void, GLenum, GLint, GLsizei)
E(glFinish, void, void)
E(glReadPixels, void, GLint, GLint, GLsizei, GLsizei, GLenum, GLenum, void*)
E(glGetError, GLenum, void)
E(glGenVertexArrays, void, GLsizei, GLuint*)
E(glBindVertexArray, void, GLuint)
E(glGetString, const GLubyte*, GLenum)
#undef E

static void* egl_lib;
template <typename T>
static void resolve(T& fn, const char* name) {
    fn = (T)dlsym(egl_lib, name);
    if (!fn && eglGetProcAddress) fn = (T)eglGetProcAddress(name);
    if (!fn) { fprintf(stderr, "glcheck: cannot resolve %s\n", name); exit(2); }
}

static std::string read_file(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) { fprintf(stderr, "glcheck: cannot open %s\n", path); exit(2); }
    std::string s;
    char buf[65536];
    size_t n;
    while ((n = fread(buf, 1, sizeof buf, f)) > 0) s.append(buf, n);
    fclose(f);
    return s;
}

static GLuint compile(GLenum type, const std::string& src) {
    GLuint s = glCreateShader(type);
    const GLchar* p = src.c_str();
    glShaderSource(s, 1, &p, nullptr);
    glCompileShader(s);
    GLint ok = 0;
    glGetShaderiv(s, GL_COMPILE_STATUS, &ok);
    if (!ok) {
        char log[4096];
        GLsizei n = 0;
        glGetShaderInfoLog(s, sizeof log, &n, log);
        fprintf(stderr, "glcheck: %s shader COMPILE FAILED:\n%.*s\n",
                type == GL_VERTEX_SHADER ? "vertex" : "fragment", n, log);
        exit(1);
    }
    return s;
}

int main(int argc, char** argv) {
    if (argc < 8) {
        fprintf(stderr, "usage: glcheck vs.glsl fs.glsl volume.r8 W H D "
                        "out.ppm [az el dist [emit.r8]]\n");
        return 2;
    }
    setenv("LIBGL_ALWAYS_SOFTWARE", "1", 0);  // llvmpipe/softpipe
    egl_lib = dlopen("libEGL.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (!egl_lib) { fprintf(stderr, "glcheck: no libEGL.so.1\n"); return 2; }
    resolve(eglGetProcAddress, "eglGetProcAddress");
    resolve(eglInitialize, "eglInitialize");
    resolve(eglBindAPI, "eglBindAPI");
    resolve(eglChooseConfig, "eglChooseConfig");
    resolve(eglCreateContext, "eglCreateContext");
    resolve(eglMakeCurrent, "eglMakeCurrent");
    resolve(eglGetError, "eglGetError");

    auto getPlatformDisplay =
        (PFN_GetPlatformDisplay)eglGetProcAddress("eglGetPlatformDisplayEXT");
    EGLDisplay dpy = EGL_NO_DISPLAY;
    if (getPlatformDisplay)
        dpy = getPlatformDisplay(EGL_PLATFORM_SURFACELESS_MESA, nullptr, nullptr);
    if (!dpy) { fprintf(stderr, "glcheck: no surfaceless display\n"); return 2; }
    EGLint maj = 0, min = 0;
    if (!eglInitialize(dpy, &maj, &min)) {
        fprintf(stderr, "glcheck: eglInitialize failed 0x%x\n", eglGetError());
        return 2;
    }
    eglBindAPI(EGL_OPENGL_ES_API);
    EGLint cfg_attrs[] = {EGL_SURFACE_TYPE, 0,
                          EGL_RENDERABLE_TYPE, EGL_OPENGL_ES3_BIT, EGL_NONE};
    EGLConfig cfg;
    EGLint ncfg = 0;
    eglChooseConfig(dpy, cfg_attrs, &cfg, 1, &ncfg);
    EGLint ctx_attrs[] = {EGL_CONTEXT_MAJOR_VERSION, 3, EGL_NONE};
    EGLContext ctx = eglCreateContext(dpy, ncfg ? cfg : nullptr,
                                      EGL_NO_CONTEXT, ctx_attrs);
    if (!ctx) { fprintf(stderr, "glcheck: eglCreateContext failed 0x%x\n",
                        eglGetError()); return 2; }
    // EGL_KHR_surfaceless_context: current with no surface, render to FBO
    if (!eglMakeCurrent(dpy, EGL_NO_SURFACE, EGL_NO_SURFACE, ctx)) {
        fprintf(stderr, "glcheck: eglMakeCurrent failed 0x%x\n", eglGetError());
        return 2;
    }

#define R(n) resolve(n, #n)
    R(glCreateShader); R(glShaderSource); R(glCompileShader); R(glGetShaderiv);
    R(glGetShaderInfoLog); R(glCreateProgram); R(glAttachShader);
    R(glLinkProgram); R(glGetProgramiv); R(glGetProgramInfoLog); R(glUseProgram);
    R(glGenBuffers); R(glBindBuffer); R(glBufferData); R(glGetAttribLocation);
    R(glEnableVertexAttribArray); R(glVertexAttribPointer);
    R(glGetUniformLocation); R(glUniform3fv); R(glUniform1f); R(glUniform1i);
    R(glGenTextures); R(glActiveTexture); R(glBindTexture); R(glTexParameteri);
    R(glTexImage3D); R(glPixelStorei); R(glGenFramebuffers);
    R(glBindFramebuffer); R(glGenRenderbuffers); R(glBindRenderbuffer);
    R(glRenderbufferStorage); R(glFramebufferRenderbuffer);
    R(glCheckFramebufferStatus); R(glViewport); R(glClearColor); R(glClear);
    R(glDrawArrays); R(glFinish); R(glReadPixels); R(glGetError);
    R(glGenVertexArrays); R(glBindVertexArray); R(glGetString);
#undef R
    fprintf(stderr, "glcheck: GL_VERSION = %s\n", (const char*)glGetString(0x1F02));

    const int W = 480, H = 360;
    GLuint fbo, rbo;
    glGenFramebuffers(1, &fbo);
    glBindFramebuffer(GL_FRAMEBUFFER, fbo);
    glGenRenderbuffers(1, &rbo);
    glBindRenderbuffer(GL_RENDERBUFFER, rbo);
    glRenderbufferStorage(GL_RENDERBUFFER, GL_RGBA8, W, H);
    glFramebufferRenderbuffer(GL_FRAMEBUFFER, GL_COLOR_ATTACHMENT0,
                              GL_RENDERBUFFER, rbo);
    if (glCheckFramebufferStatus(GL_FRAMEBUFFER) != GL_FRAMEBUFFER_COMPLETE) {
        fprintf(stderr, "glcheck: FBO incomplete\n");
        return 2;
    }

    // shaders: the page's exact strings, extracted by the caller
    std::string vs = read_file(argv[1]), fs = read_file(argv[2]);
    GLuint prog = glCreateProgram();
    glAttachShader(prog, compile(GL_VERTEX_SHADER, vs));
    glAttachShader(prog, compile(GL_FRAGMENT_SHADER, fs));
    glLinkProgram(prog);
    GLint ok = 0;
    glGetProgramiv(prog, GL_LINK_STATUS, &ok);
    if (!ok) {
        char log[4096];
        GLsizei n = 0;
        glGetProgramInfoLog(prog, sizeof log, &n, log);
        fprintf(stderr, "glcheck: LINK FAILED:\n%.*s\n", n, log);
        return 1;
    }
    glUseProgram(prog);

    // fullscreen triangle, same as the page
    GLuint vao, quad;
    glGenVertexArrays(1, &vao);
    glBindVertexArray(vao);
    glGenBuffers(1, &quad);
    glBindBuffer(GL_ARRAY_BUFFER, quad);
    const float tri[] = {-1, -1, 3, -1, -1, 3};
    glBufferData(GL_ARRAY_BUFFER, sizeof tri, tri, GL_STATIC_DRAW);
    GLint loc = glGetAttribLocation(prog, "aPos");
    glEnableVertexAttribArray(loc);
    glVertexAttribPointer(loc, 2, GL_FLOAT, 0, 0, nullptr);

    // R8 3D textures, the page's texImage3D call
    int dw = atoi(argv[4]), dh = atoi(argv[5]), dd = atoi(argv[6]);
    auto upload = [&](int unit, const char* path) {
        GLuint t;
        glGenTextures(1, &t);
        glActiveTexture(GL_TEXTURE0 + unit);
        glBindTexture(GL_TEXTURE_3D, t);
        for (GLenum k : {GL_TEXTURE_MIN_FILTER, GL_TEXTURE_MAG_FILTER})
            glTexParameteri(GL_TEXTURE_3D, k, GL_LINEAR);
        for (GLenum k : {GL_TEXTURE_WRAP_S, GL_TEXTURE_WRAP_T, GL_TEXTURE_WRAP_R})
            glTexParameteri(GL_TEXTURE_3D, k, GL_CLAMP_TO_EDGE);
        std::string raw = read_file(path);
        if ((int)raw.size() != dw * dh * dd) {
            fprintf(stderr, "glcheck: %s: %zu bytes != %d\n", path, raw.size(),
                    dw * dh * dd);
            exit(2);
        }
        glPixelStorei(GL_UNPACK_ALIGNMENT, 1);
        glTexImage3D(GL_TEXTURE_3D, 0, GL_R8, dw, dh, dd, 0, GL_RED,
                     GL_UNSIGNED_BYTE, raw.data());
    };
    upload(0, argv[3]);
    int has_emit = argc > 11 ? 1 : 0;
    if (has_emit) upload(1, argv[11]);

    // the page's orbit-camera uniform math (draw() in webapp.py)
    double az = argc > 8 ? atof(argv[8]) : 0.7;
    double el = argc > 9 ? atof(argv[9]) : 0.35;
    double dist = argc > 10 ? atof(argv[10]) : 2.4;
    float c[3] = {0.5f, 0.5f, 0.5f};
    float cam[3] = {(float)(c[0] + dist * cos(el) * cos(az)),
                    (float)(c[1] + dist * sin(el)),
                    (float)(c[2] + dist * cos(el) * sin(az))};
    float fwd[3] = {c[0] - cam[0], c[1] - cam[1], c[2] - cam[2]};
    float fl = sqrtf(fwd[0] * fwd[0] + fwd[1] * fwd[1] + fwd[2] * fwd[2]);
    for (auto& v : fwd) v /= fl;
    float right[3] = {(float)-sin(az), 0.0f, (float)cos(az)};
    float up[3] = {fwd[1] * right[2] - fwd[2] * right[1],
                   fwd[2] * right[0] - fwd[0] * right[2],
                   fwd[0] * right[1] - fwd[1] * right[0]};
    float fwd_scaled[3] = {fwd[0] * 1.2f, fwd[1] * 1.2f, fwd[2] * 1.2f};
    auto U = [&](const char* n) { return glGetUniformLocation(prog, n); };
    glViewport(0, 0, W, H);
    glUniform3fv(U("uCam"), 1, cam);
    glUniform3fv(U("uFwd"), 1, fwd_scaled);
    glUniform3fv(U("uRight"), 1, right);
    glUniform3fv(U("uUp"), 1, up);
    glUniform1f(U("uAspect"), (float)W / H);
    glUniform1f(U("uDScale"), 14.0f);
    glUniform1f(U("uEScale"), 4.0f);
    glUniform1i(U("uSteps"), 256);
    glUniform1i(U("uHasEmit"), has_emit);
    glUniform1i(U("uDen"), 0);
    glUniform1i(U("uEmit"), 1);
    glClearColor(0, 0, 0, 1);
    glClear(GL_COLOR_BUFFER_BIT);
    glDrawArrays(GL_TRIANGLES, 0, 3);
    glFinish();
    GLenum err = glGetError();
    if (err) { fprintf(stderr, "glcheck: GL error 0x%x\n", err); return 1; }

    std::vector<unsigned char> px(W * H * 4);
    glReadPixels(0, 0, W, H, GL_RGBA, GL_UNSIGNED_BYTE, px.data());
    FILE* out = fopen(argv[7], "wb");
    fprintf(out, "P6\n%d %d\n255\n", W, H);
    for (int y = H - 1; y >= 0; --y)  // GL rows are bottom-up
        for (int x = 0; x < W; ++x)
            fwrite(&px[(y * W + x) * 4], 1, 3, out);
    fclose(out);
    fprintf(stderr, "glcheck: OK, wrote %s\n", argv[7]);
    return 0;
}
