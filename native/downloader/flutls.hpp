// flutls — minimal TLS client transport over a pre-connected socket.
//
// Build-image constraint: OpenSSL 3 runtime libraries (libssl.so.3 /
// libcrypto.so.3) are present but the development headers are not, and
// nothing may be installed. So this binds the small, ABI-stable slice of
// the OpenSSL 3 API we need via dlopen/dlsym with our own prototypes —
// a native TLS backend with zero build-time dependencies.
//
// Gives the downloader the https:// capability of the reference
// (libs/flu/downloader/lib/fludownloader.c:710-748 — curl SSL setup) and
// feeds its SSL status taxonomy (fludownloader.h:18-82).

#pragma once

#include <dlfcn.h>
#include <poll.h>

#include <cerrno>
#include <cstring>
#include <string>

namespace flutls {

// SSL status taxonomy (reference fludownloader.h:50-82). We emit the
// subset a native backend can distinguish; the curl-engine-specific codes
// exist for API parity.
enum SslStatus {
  SSL_STATUS_OK = 0,
  SSL_STATUS_CONNECT_ERROR,
  SSL_STATUS_ENGINE_NOT_FOUND,
  SSL_STATUS_ENGINE_SET_FAILED,
  SSL_STATUS_CERTPROBLEM,
  SSL_STATUS_CIPHER,
  SSL_STATUS_CACERT,
  SSL_STATUS_ENGINE_INIT_FAILED,
  SSL_STATUS_CACERT_BADFILE,
  SSL_STATUS_SHUTDOWN_FAILED,
  SSL_STATUS_CRL_BADFILE,
  SSL_STATUS_ISSUER_ERROR,
  SSL_STATUS_PINNEDPUBKEY_MISMATCH,
  SSL_STATUS_INVALIDCERTSTATUS,
  SSL_STATUS_NO_TASK,
};

// Opaque OpenSSL types — we only pass pointers through.
struct SSL_CTX;
struct SSL;
struct SSL_METHOD;

// SSL_get_error results (stable ABI constants since OpenSSL 0.9).
enum {
  kSslErrorNone = 0,
  kSslErrorSsl = 1,
  kSslErrorWantRead = 2,
  kSslErrorWantWrite = 3,
  kSslErrorSyscall = 5,
  kSslErrorZeroReturn = 6,
};

struct Api {
  void* libssl = nullptr;
  void* libcrypto = nullptr;

  const SSL_METHOD* (*TLS_client_method)(void) = nullptr;
  SSL_CTX* (*SSL_CTX_new)(const SSL_METHOD*) = nullptr;
  void (*SSL_CTX_free)(SSL_CTX*) = nullptr;
  int (*SSL_CTX_set_default_verify_paths)(SSL_CTX*) = nullptr;
  int (*SSL_CTX_load_verify_locations)(SSL_CTX*, const char*,
                                       const char*) = nullptr;
  void (*SSL_CTX_set_verify)(SSL_CTX*, int, void*) = nullptr;
  SSL* (*SSL_new)(SSL_CTX*) = nullptr;
  void (*SSL_free)(SSL*) = nullptr;
  int (*SSL_set_fd)(SSL*, int) = nullptr;
  long (*SSL_ctrl)(SSL*, int, long, void*) = nullptr;
  int (*SSL_set1_host)(SSL*, const char*) = nullptr;
  int (*SSL_connect)(SSL*) = nullptr;
  int (*SSL_read)(SSL*, void*, int) = nullptr;
  int (*SSL_write)(SSL*, const void*, int) = nullptr;
  int (*SSL_get_error)(const SSL*, int) = nullptr;
  int (*SSL_pending)(const SSL*) = nullptr;
  int (*SSL_shutdown)(SSL*) = nullptr;
  long (*SSL_get_verify_result)(const SSL*) = nullptr;
  unsigned long (*ERR_get_error)(void) = nullptr;
  void (*ERR_error_string_n)(unsigned long, char*, size_t) = nullptr;
  void (*ERR_clear_error)(void) = nullptr;

  bool ok = false;

  static const Api& get() {
    static Api api;
    return api;
  }

 private:
  template <typename F>
  bool sym(void* lib, const char* name, F* out) {
    *out = reinterpret_cast<F>(dlsym(lib, name));
    return *out != nullptr;
  }

  Api() {
    libssl = dlopen("libssl.so.3", RTLD_NOW | RTLD_GLOBAL);
    if (libssl == nullptr) libssl = dlopen("libssl.so", RTLD_NOW | RTLD_GLOBAL);
    libcrypto = dlopen("libcrypto.so.3", RTLD_NOW | RTLD_GLOBAL);
    if (libcrypto == nullptr)
      libcrypto = dlopen("libcrypto.so", RTLD_NOW | RTLD_GLOBAL);
    if (libssl == nullptr) return;
    void* crypt = libcrypto != nullptr ? libcrypto : libssl;
    ok = sym(libssl, "TLS_client_method", &TLS_client_method) &&
         sym(libssl, "SSL_CTX_new", &SSL_CTX_new) &&
         sym(libssl, "SSL_CTX_free", &SSL_CTX_free) &&
         sym(libssl, "SSL_CTX_set_default_verify_paths",
             &SSL_CTX_set_default_verify_paths) &&
         sym(libssl, "SSL_CTX_load_verify_locations",
             &SSL_CTX_load_verify_locations) &&
         sym(libssl, "SSL_CTX_set_verify", &SSL_CTX_set_verify) &&
         sym(libssl, "SSL_new", &SSL_new) &&
         sym(libssl, "SSL_free", &SSL_free) &&
         sym(libssl, "SSL_set_fd", &SSL_set_fd) &&
         sym(libssl, "SSL_ctrl", &SSL_ctrl) &&
         sym(libssl, "SSL_set1_host", &SSL_set1_host) &&
         sym(libssl, "SSL_connect", &SSL_connect) &&
         sym(libssl, "SSL_read", &SSL_read) &&
         sym(libssl, "SSL_write", &SSL_write) &&
         sym(libssl, "SSL_get_error", &SSL_get_error) &&
         sym(libssl, "SSL_pending", &SSL_pending) &&
         sym(libssl, "SSL_shutdown", &SSL_shutdown) &&
         sym(libssl, "SSL_get_verify_result", &SSL_get_verify_result) &&
         sym(crypt, "ERR_get_error", &ERR_get_error) &&
         sym(crypt, "ERR_error_string_n", &ERR_error_string_n) &&
         sym(crypt, "ERR_clear_error", &ERR_clear_error);
  }
};

inline bool available() { return Api::get().ok; }

// One TLS client connection over an already-connected non-blocking fd.
class Conn {
 public:
  // Handshake with poll-driven retry on WANT_READ/WANT_WRITE. On failure
  // returns nullptr and sets *status (SslStatus) + *timed_out.
  static Conn* handshake(int fd, const std::string& sni_host, bool verify,
                         const std::string& ca_file, long timeout_ms,
                         int* status, bool* timed_out) {
    *timed_out = false;
    const Api& a = Api::get();
    if (!a.ok) {
      *status = SSL_STATUS_ENGINE_NOT_FOUND;
      return nullptr;
    }
    a.ERR_clear_error();
    SSL_CTX* ctx = a.SSL_CTX_new(a.TLS_client_method());
    if (ctx == nullptr) {
      *status = SSL_STATUS_ENGINE_INIT_FAILED;
      return nullptr;
    }
    if (verify) {
      if (!ca_file.empty()) {
        if (a.SSL_CTX_load_verify_locations(ctx, ca_file.c_str(), nullptr)
            != 1) {
          a.SSL_CTX_free(ctx);
          *status = SSL_STATUS_CACERT_BADFILE;
          return nullptr;
        }
      } else {
        a.SSL_CTX_set_default_verify_paths(ctx);
      }
      a.SSL_CTX_set_verify(ctx, 1 /* SSL_VERIFY_PEER */, nullptr);
    }
    SSL* ssl = a.SSL_new(ctx);
    if (ssl == nullptr) {
      a.SSL_CTX_free(ctx);
      *status = SSL_STATUS_ENGINE_INIT_FAILED;
      return nullptr;
    }
    a.SSL_set_fd(ssl, fd);
    bool ip_literal = is_ip_literal(sni_host);
    if (!ip_literal) {
      // SNI: SSL_set_tlsext_host_name is a macro over SSL_ctrl(55, 0, name)
      a.SSL_ctrl(ssl, 55, 0, const_cast<char*>(sni_host.c_str()));
      if (verify) a.SSL_set1_host(ssl, sni_host.c_str());
    }
    for (;;) {
      int rc = a.SSL_connect(ssl);
      if (rc == 1) break;
      int err = a.SSL_get_error(ssl, rc);
      if (err == kSslErrorWantRead || err == kSslErrorWantWrite) {
        struct pollfd pfd = {fd,
                             (short)(err == kSslErrorWantRead ? POLLIN
                                                              : POLLOUT),
                             0};
        int prc = poll(&pfd, 1, (int)timeout_ms);
        if (prc > 0) continue;
        *timed_out = prc == 0;
        *status = SSL_STATUS_CONNECT_ERROR;
        a.SSL_free(ssl);
        a.SSL_CTX_free(ctx);
        return nullptr;
      }
      // distinguish verification failures (→ CACERT) from other errors
      long vr = a.SSL_get_verify_result(ssl);
      *status = vr != 0 /* X509_V_OK */ ? SSL_STATUS_CACERT
                                        : SSL_STATUS_CONNECT_ERROR;
      a.SSL_free(ssl);
      a.SSL_CTX_free(ctx);
      return nullptr;
    }
    if (verify && a.SSL_get_verify_result(ssl) != 0) {
      *status = SSL_STATUS_CACERT;
      a.SSL_shutdown(ssl);
      a.SSL_free(ssl);
      a.SSL_CTX_free(ctx);
      return nullptr;
    }
    *status = SSL_STATUS_OK;
    return new Conn(ctx, ssl);
  }

  // >0: bytes read. 0: clean close. -1: fatal error. -2: no data yet
  // (caller polls the fd and retries).
  int read(char* buf, int n) {
    const Api& a = Api::get();
    a.ERR_clear_error();
    int rc = a.SSL_read(ssl_, buf, n);
    if (rc > 0) return rc;
    int err = a.SSL_get_error(ssl_, rc);
    if (err == kSslErrorZeroReturn) return 0;
    if (err == kSslErrorWantRead || err == kSslErrorWantWrite) return -2;
    if (err == kSslErrorSyscall && rc == 0) return 0;  // unclean EOF
    return -1;
  }

  // Plaintext already decrypted and buffered inside OpenSSL — must be
  // drained before polling the socket or the tail of a response stalls.
  int pending() const { return Api::get().SSL_pending(ssl_); }

  // Write all n bytes (poll-driven). Returns false on error/timeout.
  bool write_all(const char* buf, int n, int fd, long timeout_ms) {
    const Api& a = Api::get();
    int off = 0;
    while (off < n) {
      a.ERR_clear_error();
      int rc = a.SSL_write(ssl_, buf + off, n - off);
      if (rc > 0) {
        off += rc;
        continue;
      }
      int err = a.SSL_get_error(ssl_, rc);
      if (err != kSslErrorWantRead && err != kSslErrorWantWrite) return false;
      struct pollfd pfd = {fd,
                           (short)(err == kSslErrorWantRead ? POLLIN
                                                            : POLLOUT),
                           0};
      if (poll(&pfd, 1, (int)timeout_ms) <= 0) return false;
    }
    return true;
  }

  ~Conn() {
    const Api& a = Api::get();
    a.SSL_shutdown(ssl_);  // best-effort close_notify
    a.SSL_free(ssl_);
    a.SSL_CTX_free(ctx_);
  }

 private:
  Conn(SSL_CTX* ctx, SSL* ssl) : ctx_(ctx), ssl_(ssl) {}

  static bool is_ip_literal(const std::string& h) {
    if (h.find(':') != std::string::npos) return true;  // v6
    bool digits_dots = !h.empty();
    for (char c : h)
      if (c != '.' && (c < '0' || c > '9')) digits_dots = false;
    return digits_dots;
  }

  SSL_CTX* ctx_;
  SSL* ssl_;
};

}  // namespace flutls
