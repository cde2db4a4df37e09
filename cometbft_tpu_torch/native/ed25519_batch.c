/* Native Ed25519 batch verification: the port's native CPU rung.
 *
 * Reference: cometbft_tpu/native/ed25519_batch.c (a copy). One call a
 * batch, the GIL released by ctypes, pthreads inside split the batch
 * across cores, each thread looping OpenSSL's EVP_DigestVerify; sign and
 * key derivation for one key; and cbft_ed25519_challenges,
 * h = SHA-512(R || A || M) mod L for a batch of lanes.
 *
 * Semantics: OpenSSL's Ed25519 verify (cofactorless, rejects s >= L),
 * which crypto/purepy.py follows; native/__init__.py checks the two
 * agree on the contract's cases before it uses this library.
 *
 * Build (native/__init__.py does it at first use):
 *   cc -O2 -shared -fPIC -o libcbft_ed25519.so ed25519_batch.c -pthread -lcrypto
 */

#include <pthread.h>
#include <stddef.h>
#include <string.h>

/* The build image ships libcrypto.so.3 without dev headers; the EVP
 * functions used below have had a stable ABI since OpenSSL 1.1.1, so we
 * declare them directly. EVP_PKEY_ED25519 == NID_ED25519 == 1087. */
typedef struct evp_pkey_st EVP_PKEY;
typedef struct evp_md_ctx_st EVP_MD_CTX;
typedef struct evp_md_st EVP_MD;
typedef struct engine_st ENGINE;
typedef struct evp_pkey_ctx_st EVP_PKEY_CTX;
#define EVP_PKEY_ED25519 1087
EVP_PKEY *EVP_PKEY_new_raw_public_key(int type, ENGINE *e,
                                      const unsigned char *pub, size_t len);
void EVP_PKEY_free(EVP_PKEY *pkey);
EVP_MD_CTX *EVP_MD_CTX_new(void);
void EVP_MD_CTX_free(EVP_MD_CTX *ctx);
int EVP_DigestVerifyInit(EVP_MD_CTX *ctx, EVP_PKEY_CTX **pctx,
                         const EVP_MD *type, ENGINE *e, EVP_PKEY *pkey);
int EVP_DigestVerify(EVP_MD_CTX *ctx, const unsigned char *sig,
                     size_t siglen, const unsigned char *tbs, size_t tbslen);

EVP_PKEY *EVP_PKEY_new_raw_private_key(int type, ENGINE *e,
                                       const unsigned char *priv, size_t len);
int EVP_PKEY_get_raw_public_key(const EVP_PKEY *pkey, unsigned char *pub,
                                size_t *len);
int EVP_DigestSignInit(EVP_MD_CTX *ctx, EVP_PKEY_CTX **pctx,
                       const EVP_MD *type, ENGINE *e, EVP_PKEY *pkey);
int EVP_DigestSign(EVP_MD_CTX *ctx, unsigned char *sig, size_t *siglen,
                   const unsigned char *tbs, size_t tbslen);

typedef struct {
    const unsigned char *pubs;   /* n * 32 */
    const unsigned char *msgs;   /* concatenated */
    const size_t *msg_off;       /* n offsets into msgs */
    const size_t *msg_len;       /* n lengths */
    const unsigned char *sigs;   /* n * 64 */
    unsigned char *out;          /* n result bytes: 1 ok / 0 bad */
    size_t begin, end;
} chunk_t;

static void *verify_chunk(void *arg)
{
    chunk_t *c = (chunk_t *)arg;
    for (size_t i = c->begin; i < c->end; i++) {
        unsigned char ok = 0;
        EVP_PKEY *pk = EVP_PKEY_new_raw_public_key(
            EVP_PKEY_ED25519, NULL, c->pubs + 32 * i, 32);
        if (pk != NULL) {
            EVP_MD_CTX *ctx = EVP_MD_CTX_new();
            if (ctx != NULL) {
                if (EVP_DigestVerifyInit(ctx, NULL, NULL, NULL, pk) == 1 &&
                    EVP_DigestVerify(ctx, c->sigs + 64 * i, 64,
                                     c->msgs + c->msg_off[i],
                                     c->msg_len[i]) == 1)
                    ok = 1;
                EVP_MD_CTX_free(ctx);
            }
            EVP_PKEY_free(pk);
        }
        c->out[i] = ok;
    }
    return NULL;
}

/* Returns 0 on success. nthreads <= 1 runs inline (no thread spawn). */
int cbft_ed25519_verify_batch(const unsigned char *pubs,
                              const unsigned char *msgs,
                              const size_t *msg_off, const size_t *msg_len,
                              const unsigned char *sigs, unsigned char *out,
                              size_t n, int nthreads)
{
    if (n == 0)
        return 0;
    if (nthreads <= 1 || (size_t)nthreads > n) {
        chunk_t c = {pubs, msgs, msg_off, msg_len, sigs, out, 0, n};
        verify_chunk(&c);
        return 0;
    }
    enum { MAX_THREADS = 64 };
    if (nthreads > MAX_THREADS)
        nthreads = MAX_THREADS;
    pthread_t tids[MAX_THREADS];
    chunk_t chunks[MAX_THREADS];
    size_t per = n / nthreads, rem = n % nthreads, pos = 0;
    int spawned = 0;
    for (int t = 0; t < nthreads; t++) {
        size_t take = per + (t < (int)rem ? 1 : 0);
        chunks[t] = (chunk_t){pubs, msgs, msg_off, msg_len,
                              sigs, out, pos, pos + take};
        pos += take;
        if (t == nthreads - 1) {
            /* run the last chunk on the calling thread */
            verify_chunk(&chunks[t]);
        } else if (pthread_create(&tids[spawned], NULL, verify_chunk,
                                  &chunks[t]) == 0) {
            spawned++;
        } else {
            verify_chunk(&chunks[t]); /* spawn failed: run inline */
        }
    }
    for (int t = 0; t < spawned; t++)
        pthread_join(tids[t], NULL);
    return 0;
}

/* --- single-key sign / keygen ------------------------------------------
 *
 * The image may lack the Python `cryptography` wheel entirely; these two
 * entry points let crypto/ed25519.py keep OpenSSL semantics for signing
 * and seed→pubkey derivation through the same ctypes .so instead of
 * dropping to the (much slower) pure-Python scalar path. */

/* Returns 0 on success; sig_out receives 64 bytes. */
int cbft_ed25519_sign(const unsigned char *seed, const unsigned char *msg,
                      size_t msglen, unsigned char *sig_out)
{
    int rc = 1;
    EVP_PKEY *pk = EVP_PKEY_new_raw_private_key(
        EVP_PKEY_ED25519, NULL, seed, 32);
    if (pk != NULL) {
        EVP_MD_CTX *ctx = EVP_MD_CTX_new();
        if (ctx != NULL) {
            size_t siglen = 64;
            if (EVP_DigestSignInit(ctx, NULL, NULL, NULL, pk) == 1 &&
                EVP_DigestSign(ctx, sig_out, &siglen, msg, msglen) == 1 &&
                siglen == 64)
                rc = 0;
            EVP_MD_CTX_free(ctx);
        }
        EVP_PKEY_free(pk);
    }
    return rc;
}

/* Returns 0 on success; pub_out receives 32 bytes. */
int cbft_ed25519_pub_from_seed(const unsigned char *seed,
                               unsigned char *pub_out)
{
    int rc = 1;
    EVP_PKEY *pk = EVP_PKEY_new_raw_private_key(
        EVP_PKEY_ED25519, NULL, seed, 32);
    if (pk != NULL) {
        size_t publen = 32;
        if (EVP_PKEY_get_raw_public_key(pk, pub_out, &publen) == 1 &&
            publen == 32)
            rc = 0;
        EVP_PKEY_free(pk);
    }
    return rc;
}

/* --- batch challenge scalars: h = SHA-512(R ‖ A ‖ M) mod L ------------
 *
 * Host-side packing of the card's wire-key routes
 * (crypto/cuda/ed25519_batch.py _challenge_scalars): the Python
 * loop pays ~6 us/sig (hashlib call + 512-bit int mod); this native
 * loop is one call per batch with the same pthread chunking as the
 * verifier above. Output is 32 little-endian bytes per lane; lanes
 * with valid[i] == 0 are skipped (left zeroed). */

typedef struct bignum_st BIGNUM;
typedef struct bignum_ctx BN_CTX;
BIGNUM *BN_lebin2bn(const unsigned char *s, size_t len, BIGNUM *ret);
int BN_bn2lebinpad(const BIGNUM *a, unsigned char *to, size_t tolen);
int BN_div(BIGNUM *dv, BIGNUM *rem, const BIGNUM *m, const BIGNUM *d,
           BN_CTX *ctx);
BIGNUM *BN_new(void);
void BN_free(BIGNUM *a);
BN_CTX *BN_CTX_new(void);
void BN_CTX_free(BN_CTX *c);
const EVP_MD *EVP_sha512(void);
int EVP_DigestInit_ex(EVP_MD_CTX *ctx, const EVP_MD *type, ENGINE *impl);
int EVP_DigestUpdate(EVP_MD_CTX *ctx, const void *d, size_t cnt);
int EVP_DigestFinal_ex(EVP_MD_CTX *ctx, unsigned char *md, unsigned int *s);

/* L = 2^252 + 27742317777372353535851937790883648493, little-endian */
static const unsigned char CBFT_L_LE[32] = {
    0xed, 0xd3, 0xf5, 0x5c, 0x1a, 0x63, 0x12, 0x58,
    0xd6, 0x9c, 0xf7, 0xa2, 0xde, 0xf9, 0xde, 0x14,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x10,
};

typedef struct {
    const unsigned char *pubs;   /* n * 32 (A) */
    const unsigned char *rs;     /* n * 32 (R) */
    const unsigned char *msgs;   /* concatenated */
    const size_t *msg_off;
    const size_t *msg_len;
    const unsigned char *valid;  /* n: 0 = skip lane */
    unsigned char *out;          /* n * 32 LE */
    size_t begin, end;
    int rc;
} hchunk_t;

static void *challenge_chunk(void *arg)
{
    hchunk_t *c = (hchunk_t *)arg;
    EVP_MD_CTX *ctx = EVP_MD_CTX_new();
    BIGNUM *L = BN_lebin2bn(CBFT_L_LE, 32, NULL);
    BIGNUM *h = BN_new();
    BIGNUM *rem = BN_new();
    BN_CTX *bctx = BN_CTX_new();
    if (ctx == NULL || L == NULL || h == NULL || rem == NULL ||
        bctx == NULL) {
        c->rc = 1;
        goto done;
    }
    for (size_t i = c->begin; i < c->end; i++) {
        unsigned char digest[64];
        unsigned int dlen = 0;
        if (!c->valid[i])
            continue;
        if (EVP_DigestInit_ex(ctx, EVP_sha512(), NULL) != 1 ||
            EVP_DigestUpdate(ctx, c->rs + 32 * i, 32) != 1 ||
            EVP_DigestUpdate(ctx, c->pubs + 32 * i, 32) != 1 ||
            EVP_DigestUpdate(ctx, c->msgs + c->msg_off[i],
                             c->msg_len[i]) != 1 ||
            EVP_DigestFinal_ex(ctx, digest, &dlen) != 1 || dlen != 64 ||
            BN_lebin2bn(digest, 64, h) == NULL ||
            BN_div(NULL, rem, h, L, bctx) != 1 ||
            BN_bn2lebinpad(rem, c->out + 32 * i, 32) != 32) {
            c->rc = 1;
            goto done;
        }
    }
done:
    if (ctx) EVP_MD_CTX_free(ctx);
    if (L) BN_free(L);
    if (h) BN_free(h);
    if (rem) BN_free(rem);
    if (bctx) BN_CTX_free(bctx);
    return NULL;
}

/* Returns 0 on success (any lane failure poisons the call — callers
 * fall back to the Python path rather than trust partial output). */
int cbft_ed25519_challenges(const unsigned char *pubs,
                            const unsigned char *rs,
                            const unsigned char *msgs,
                            const size_t *msg_off, const size_t *msg_len,
                            const unsigned char *valid, unsigned char *out,
                            size_t n, int nthreads)
{
    if (n == 0)
        return 0;
    if (nthreads <= 1 || (size_t)nthreads > n) {
        hchunk_t c = {pubs, rs, msgs, msg_off, msg_len,
                      valid, out, 0, n, 0};
        challenge_chunk(&c);
        return c.rc;
    }
    enum { MAX_THREADS = 64 };
    if (nthreads > MAX_THREADS)
        nthreads = MAX_THREADS;
    pthread_t tids[MAX_THREADS];
    hchunk_t chunks[MAX_THREADS];
    size_t per = n / nthreads, rem = n % nthreads, pos = 0;
    int spawned = 0;
    for (int t = 0; t < nthreads; t++) {
        size_t take = per + (t < (int)rem ? 1 : 0);
        chunks[t] = (hchunk_t){pubs, rs, msgs, msg_off, msg_len,
                               valid, out, pos, pos + take, 0};
        pos += take;
        if (t == nthreads - 1) {
            challenge_chunk(&chunks[t]);
        } else if (pthread_create(&tids[spawned], NULL, challenge_chunk,
                                  &chunks[t]) == 0) {
            spawned++;
        } else {
            challenge_chunk(&chunks[t]);
        }
    }
    for (int t = 0; t < spawned; t++)
        pthread_join(tids[t], NULL);
    int rc = 0;
    for (int t = 0; t < nthreads; t++)
        rc |= chunks[t].rc;
    return rc;
}
